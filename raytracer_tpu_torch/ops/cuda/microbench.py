"""The microbenchmark kernels MB1–MB4 (``csrc/microbench.cu``): wrappers,
launch counts, plain torch versions, the sweep of their variants and the
timing of one variant.

They ask of the H100 what ``tools/mb_kernel.py``, ``tools/mb_kernel2.py``
and ``tools/mb_smem_probe.py`` asked of the TPU: what one iteration of a
primitive costs (a dependent or pipelined fetch of 512-byte rows from L1, L2
or device memory, shared-memory and L1 reads, broadcasts across a warp, a
warp reduction, one traversal visit and its parts) and how large a block's
shared memory may be. Each kernel runs one warp for ``n`` iterations and
writes a checksum that its loop feeds; the sweep times two values of n with
CUDA events and reports (t(n_hi) − t(n_lo)) / (n_hi − n_lo), best of 3, and
the same difference of the kernel's own ``clock64()`` cycles.

Checksums. The row walk keeps the TPU kernels' ``a += row[1]`` (in their
row order), the empty loop their Σ i (int32) and the reduction theirs
(Σ int(v), with v scaled by 1.000001 each iteration): the plain versions
here equal the Pallas kernels run in interpret mode. The others are the
port's own, each computed by its plain version in the kernel's order with
the same f32 roundings.

Each wrapper returns its plain version's dict: on CUDA tensors it launches
its kernel (and raises if the launch is refused) and reads the result back;
on CPU tensors it runs the plain version. :func:`sweep` lists every variant
with its wrapper, its plain version and its bare launch (device outputs,
cycles last: what :func:`per_iteration` times).
"""

from __future__ import annotations

import ctypes
import functools
import statistics
from collections.abc import Callable, Iterator
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["LAUNCHES", "reset_launches", "load_microbench", "walk_table", "set_walk_span",
           "mb_walk", "mb_walk_reference", "mb_scalar", "mb_scalar_reference", "SCALAR_VARIANTS",
           "visit_record", "VISIT_RAY", "VISIT_PARTS", "mb_visit", "mb_visit_reference",
           "mb_smem_probe", "mb_smem_probe_reference", "smem_capacity", "WALK_VARIANTS",
           "WALK_SIZES", "Variant", "sweep", "per_iteration", "REC_WORDS_4WIDE_K32",
           "REC_WORDS_8WIDE_K32"]

LAUNCHES = {"mb_walk": 0, "mb_scalar": 0, "mb_visit": 0, "mb_smem_probe": 0}

ROW_WORDS = 128            # a 512-byte row, the TPU tables' (rows, 128) f32
WALK_STRIDE = 97           # row_i = (i · 97) mod span, the TPU scripts' walk
# table rows at each level of the memory hierarchy: 64 KB (L1), the TPU
# scripts' 16,384 rows = 8 MiB (L2), 1 GiB (device memory)
WALK_SIZES = {"L1": 128, "L2": 16_384, "HBM": 2_097_152}
# (name, rows_per, chains, mode): mode 0 dependent, 1 dependent with the
# vector rounds, 2 pipelined (cp.async); the TPU script's names where they
# carry over (dma512 / dma2k / dma8k / dma2k_x4 / dma2k_vec / dma2k_pipe,
# dma_smem_pipe)
WALK_VARIANTS = (("dep512", 1, 1, 0), ("dep2k", 4, 1, 0), ("dep8k", 16, 1, 0),
                 ("dep512_x2", 1, 2, 0), ("dep512_x4", 1, 4, 0), ("dep2k_x4", 4, 4, 0),
                 ("dep2k_vec", 4, 1, 1), ("pipe512", 1, 1, 2), ("pipe2k", 4, 1, 2))
SCALAR_VARIANTS = {"loop": 0, "smem24": 1, "l1x24": 2, "shfl_bcast": 3, "smem_bcast": 4,
                   "l1_bcast": 5, "reduce": 6}
VISIT_PARTS = {"slab": 1, "mt": 2, "sort": 4, "stack": 8, "visit": 15}
_STACK_MAX = 64
# one 4-wide and one 8-wide K = 32 record (rec_layout), in f32 words
REC_WORDS_4WIDE_K32, REC_WORDS_8WIDE_K32 = 1792, 3456


def reset_launches() -> None:
    """Set every microbenchmark kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "rt_mb_walk": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "rt_mb_scalar": [_P, _P, _I, _I, _P, _P, _P, _P],
    "rt_mb_visit": [_I, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    "rt_mb_smem_probe": [_P, _I, _P, _P],
}


@functools.cache
def load_microbench() -> tuple[ctypes.CDLL, str]:
    """Build (at first use) and load ``csrc/microbench.cu``; returns
    (library, nvcc log)."""
    from .build import build_library

    lib, log = build_library("microbench.cu")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib, log


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _check_cuda_or_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {t.device}")
    return t.device.type == "cuda"


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}'s bare launch takes CUDA tensors, got {t.device}")


def _f32_running_sum(values) -> np.float32:
    """Σ values added one after another in f32, as a loop's accumulator
    adds them (numpy's accumulate is sequential)."""
    v = np.asarray(values, dtype=np.float32).reshape(-1)
    return np.float32(0.0) if v.size == 0 else np.add.accumulate(v, dtype=np.float32)[-1]


# ---- MB1 -------------------------------------------------------------------

def walk_table(rows: int, device) -> torch.Tensor:
    """The TPU scripts' table, (rows, 128) f32 with word k = k · 1e-6 (its
    ``arange(rows · 128) · 1e-6``), made on ``device``; word 0 of each row
    is then set by :func:`set_walk_span`."""
    return (torch.arange(rows * ROW_WORDS, dtype=torch.float32, device=device)
            * 1e-6).reshape(rows, ROW_WORDS)


def set_walk_span(table: torch.Tensor, span: int, chains: int = 1) -> None:
    """Word 0 of row r := (r + 97 · ``chains``) mod ``span`` as int bits: the
    successor of r in its chain, which the dependent walk reads (in place)."""
    r = torch.arange(table.shape[0], dtype=torch.int64, device=table.device)
    table[:, 0] = ((r + WALK_STRIDE * chains) % span).to(torch.int32).view(torch.float32)


def _walk_rows(span: int, chains: int, n: int) -> np.ndarray:
    """Rows fetched, in order (i, then chain s): ((i·S + s) · 97) mod span."""
    k = np.arange(n * chains, dtype=np.int64)
    return (k * WALK_STRIDE) % span


def _vec_rounds(v: np.float32, n: int) -> np.float32:
    one_up, eps, one_down = np.float32(1.000001), np.float32(1e-7), np.float32(0.999999)
    for _ in range(n * 10):
        v = np.float32(v * one_up) + eps
        v = max(v, np.float32(v * one_down))
    return np.float32(v)


def mb_walk_reference(table: torch.Tensor, span: int, rows_per: int, mode: int, chains: int,
                      n: int) -> dict:
    """The plain version of :func:`mb_walk` → {"a", "v", "xor"}: ``a`` the
    f32 sum of word 1 of each fetch's first row in fetch order, ``v`` the
    vector rounds' value (mode 1), ``xor`` the XOR of the bits of every word
    the dependent walk loads (0 for the pipelined walk)."""
    rows = _walk_rows(span, chains, n)
    all_rows = (rows[:, None] + np.arange(rows_per)[None, :]).reshape(-1)
    # only the rows the walk reads come to the host (the table may be 1 GiB)
    t = table[torch.from_numpy(all_rows).to(table.device)].detach().cpu().numpy()
    a = _f32_running_sum(t[::rows_per, 1])
    x = 0
    if mode != 2 and rows.size:
        x = int(np.bitwise_xor.reduce(t.view(np.uint32).reshape(-1)))
    v = _vec_rounds(np.float32(0.0), n) if mode == 1 else np.float32(0.0)
    return {"a": float(a), "v": float(v), "xor": x}


def mb_walk(table: torch.Tensor, span: int, rows_per: int, mode: int, chains: int,
            n: int) -> dict:
    """MB1: ``n`` iterations of the row walk over ``table`` ((rows, 128)
    f32, word 0 set for ``span`` and ``chains`` by :func:`set_walk_span`;
    span ≤ rows − rows_per + 1). ``mode`` 0: dependent fetches, each chain's next row read
    from the row just fetched; 1: the same with the TPU kernel's vector
    rounds between fetch and use; 2: pipelined cp.async. → the plain
    version's dict."""
    if table.dim() != 2 or table.shape[1] != ROW_WORDS or table.dtype != torch.float32:
        raise ValueError("the walk's table must be (rows, 128) float32")
    if not 1 <= span <= table.shape[0] - rows_per + 1:
        raise ValueError(f"span {span} does not fit {table.shape[0]} rows of {rows_per}")
    if not _check_cuda_or_cpu(table, "mb_walk"):
        return mb_walk_reference(table, span, rows_per, mode, chains, n)
    out, xor, _ = _walk_launch(table, span, rows_per, mode, chains, n)
    return {"a": float(out[0]), "v": float(out[1]), "xor": int(xor[0]) & 0xFFFFFFFF}


def _walk_launch(table, span, rows_per, mode, chains, n):
    """MB1's launch on a CUDA table → (out (2,) f32 = [a, v], xor (1,) int32
    bits, cycles (1,) int64) on the card."""
    _require_cuda(table, "mb_walk")
    lib, _ = load_microbench()
    dev = table.device
    out = torch.zeros(2, dtype=torch.float32, device=dev)
    xor = torch.zeros(1, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_mb_walk(table.data_ptr(), span, rows_per, mode, chains, n, out.data_ptr(),
                             xor.data_ptr(), cycles.data_ptr(), _stream(dev))
    _launched("mb_walk", err)
    return out, xor, cycles


# ---- MB2 -------------------------------------------------------------------

def mb_scalar_reference(table: torch.Tensor, ones: torch.Tensor, variant: str, n: int) -> dict:
    """The plain version of :func:`mb_scalar` → {"a_int", "a", "v"}."""
    rec = table.detach().cpu().reshape(-1)[:64].numpy().astype(np.float32)
    a_int, a, v = 0, np.float32(0.0), np.float32(0.0)
    if variant == "loop":
        a_int = n * (n - 1) // 2
    elif variant in ("smem24", "l1x24"):
        s = _f32_running_sum([rec[(k * 5 + 1) % 64] for k in range(24)])
        a = _f32_running_sum(np.full(n, s, np.float32))
    elif variant in ("shfl_bcast", "smem_bcast", "l1_bcast"):
        a = _f32_running_sum(rec[np.arange(n) % 32])
    elif variant == "reduce":
        vals = ones.detach().cpu().reshape(-1)[:1024].to(torch.float32)
        for _ in range(n):
            vals = vals * 1.000001
            a_int += int(vals.to(torch.int32).sum())
        v = np.float32(vals[0])
    else:
        raise ValueError(f"unknown scalar variant {variant!r}")
    a_int = (a_int + (1 << 31)) % (1 << 32) - (1 << 31)
    return {"a_int": a_int, "a": float(a), "v": float(v)}


def mb_scalar(table: torch.Tensor, ones: torch.Tensor, variant: str, n: int) -> dict:
    """MB2: ``n`` iterations of one scalar variant (:data:`SCALAR_VARIANTS`)
    over word 0..63 of ``table`` (and, for ``reduce``, the 1,024 f32
    ``ones``) → the plain version's dict."""
    if variant not in SCALAR_VARIANTS:
        raise ValueError(f"unknown scalar variant {variant!r}")
    if table.numel() < 64 or ones.numel() < 1024 or table.device != ones.device:
        raise ValueError("mb_scalar takes >= 64 table words and 1,024 ones on one device")
    if not _check_cuda_or_cpu(table, "mb_scalar"):
        return mb_scalar_reference(table, ones, variant, n)
    a_int, out, _ = _scalar_launch(table, ones, variant, n)
    return {"a_int": int(a_int[0]), "a": float(out[0]), "v": float(out[1])}


def _scalar_launch(table, ones, variant, n):
    """MB2's launch on CUDA tensors → (a_int (1,) int32, out (2,) f32 =
    [a, v], cycles (1,) int64) on the card."""
    _require_cuda(table, "mb_scalar")
    lib, _ = load_microbench()
    dev = table.device
    a_int = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.zeros(2, dtype=torch.float32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_mb_scalar(table.data_ptr(), ones.data_ptr(), SCALAR_VARIANTS[variant], n,
                               a_int.data_ptr(), out.data_ptr(), cycles.data_ptr(), _stream(dev))
    _launched("mb_scalar", err)
    return a_int, out, cycles


# ---- MB3 -------------------------------------------------------------------

# origin (x, y, z), direction: the ray of MB3's visits, before the popped
# node's x shift of 0.125 · (node & 7)
VISIT_RAY = (-0.4, -0.3, -5.0, 0.02, 0.03, 1.0)


def visit_record(slots: int, device) -> torch.Tensor:
    """MB3's record: ``slots`` child boxes along the ray at depths 1 + k
    (slot k spans x ∈ [−1 + 0.2k, 1 + 0.2k] so that shifted rays miss some),
    child ids k + 1, and one triangle [v0, e1, e2, g] at z = 3 facing the
    ray. 8·slots + 12 f32 words."""
    w = 8 * slots + 12
    rec = torch.zeros(w, dtype=torch.float32)
    for k in range(slots):
        rec[6 * k:6 * k + 6] = torch.tensor([-1.0 + 0.2 * k, -1.0, 1.0 + k,
                                             1.0 + 0.2 * k, 1.0, 1.5 + k])
        rec[6 * slots + k] = float(k + 1)
    rec[8 * slots:] = torch.tensor([-2.0, -2.0, 3.0, 4.0, 0.0, 0.0, 0.0, 4.0, 0.0,
                                    0.0, 0.0, 16.0])
    return rec.to(device)


def mb_visit_reference(slots: int, parts: int, n: int, record: torch.Tensor,
                       ray: torch.Tensor) -> dict:
    """The plain version of :func:`mb_visit` (either record source) →
    {"acc", "best"}: the kernel's loop in np.float32, operation for
    operation."""
    f = np.float32
    h = record.detach().cpu().numpy().astype(np.float32)
    o0x, oy, oz, dx, dy, dz = (f(x) for x in ray.detach().cpu().numpy())
    one = f(1.0)
    ix, iy, iz = one / dx, one / dy, one / dz
    inf, zero = f(1e30), f(0.0)
    stack_n, stack_d = [0] * _STACK_MAX, [zero] * _STACK_MAX
    sp, node, acc, best = 0, 0, 0, inf
    m32 = 0xFFFFFFFF

    def bits(x):
        return int(np.array(x, np.float32).view(np.uint32))

    for _ in range(n):
        ox = o0x + f(0.125) * f(node & 7)
        best = inf
        hit, tmin, mask = [], [], 0
        for k in range(slots):
            b = h[6 * k:6 * k + 6]
            if parts & 1:
                t1x, t2x = (b[0] - ox) * ix, (b[3] - ox) * ix
                t1y, t2y = (b[1] - oy) * iy, (b[4] - oy) * iy
                t1z, t2z = (b[2] - oz) * iz, (b[5] - oz) * iz
                tn = max(max(min(t1x, t2x), min(t1y, t2y)), min(t1z, t2z))
                tf = min(min(max(t1x, t2x), max(t1y, t2y)), max(t1z, t2z))
                hit.append(bool(tf >= max(tn, zero) and tn < best))
                tmin.append(tn)
            else:
                hit.append(True)
                tmin.append(b[0] - ox)
            mask |= int(hit[k]) << k
        if parts & 2:
            t = h[8 * slots:8 * slots + 12]
            e1x, e1y, e1z, e2x, e2y, e2z = t[3], t[4], t[5], t[6], t[7], t[8]
            pxv = dy * e2z - dz * e2y
            pyv = dz * e2x - dx * e2z
            pzv = dx * e2y - dy * e2x
            det = e1x * pxv + e1y * pyv + e1z * pzv
            inv_det = one / (one if det == 0 else det)
            sx, sy, sz = ox - t[0], oy - t[1], oz - t[2]
            uu = inv_det * (sx * pxv + sy * pyv + sz * pzv)
            qcx = sy * e1z - sz * e1y
            qcy = sz * e1x - sx * e1z
            qcz = sx * e1y - sy * e1x
            vv = inv_det * (dx * qcx + dy * qcy + dz * qcz)
            tt = inv_det * (e2x * qcx + e2y * qcy + e2z * qcz)
            if (abs(det) >= f(1e-7) and uu >= 0 and uu <= 1 and vv >= 0 and uu + vv <= 1
                    and tt > f(1e-7) and tt < best):
                best = tt
                acc ^= bits(tt)
        cand, ckey = [], []
        for k in range(slots):
            if not hit[k]:
                continue
            cn, ck = int(h[6 * slots + k]), tmin[k]
            j = len(cand)
            if parts & 4:
                while j > 0 and ckey[j - 1] < ck:
                    j -= 1
            cand.insert(j, cn)
            ckey.insert(j, ck)
        if parts & 8:
            for cn, ck in zip(cand, ckey):
                if sp < _STACK_MAX - 1:
                    sp += 1
                    stack_n[sp], stack_d[sp] = cn, ck
            node = stack_n[sp]
            acc = (acc + bits(stack_d[sp])) & m32
            if sp > 0:
                sp -= 1
            if sp > _STACK_MAX // 2:
                sp -= _STACK_MAX // 4
        else:
            node = cand[0] if cand else node + 1
        acc = (acc + ((node & m32) * 2654435761 & m32) + mask) & m32
    return {"acc": acc, "best": float(best)}


def mb_visit(slots: int, regs: bool, parts: int, n: int, record: torch.Tensor,
             ray: torch.Tensor) -> dict:
    """MB3: ``n`` visits of ``record`` (from :func:`visit_record`) at
    ``slots`` = 4 or 8, the record held in registers (``regs``) or read from
    shared memory every visit, doing the ``parts`` of a visit
    (:data:`VISIT_PARTS` bits) → the plain version's dict."""
    if slots not in (4, 8) or record.numel() != 8 * slots + 12 or ray.numel() != 6:
        raise ValueError("mb_visit takes 4 or 8 slots, a visit_record and a 6-float ray")
    if record.device != ray.device:
        raise ValueError("record and ray must be on one device")
    if not _check_cuda_or_cpu(record, "mb_visit"):
        return mb_visit_reference(slots, parts, n, record, ray)
    acc, best, _ = _visit_launch(slots, regs, parts, n, record, ray)
    return {"acc": int(acc[0]) & 0xFFFFFFFF, "best": float(best[0])}


def _visit_launch(slots, regs, parts, n, record, ray):
    """MB3's launch on CUDA tensors → (acc (1,) int32 bits, best (1,) f32,
    cycles (1,) int64) on the card."""
    _require_cuda(record, "mb_visit")
    lib, _ = load_microbench()
    dev = record.device
    acc = torch.zeros(1, dtype=torch.int32, device=dev)
    best = torch.zeros(1, dtype=torch.float32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.rt_mb_visit(slots, int(bool(regs)), record.data_ptr(), parts, n,
                              ray.data_ptr(), acc.data_ptr(), best.data_ptr(),
                              cycles.data_ptr(), _stream(dev))
    _launched("mb_visit", err)
    return acc, best, cycles


# ---- MB4 -------------------------------------------------------------------

def mb_smem_probe_reference(x: torch.Tensor, words: int) -> float:
    """The plain version of :func:`mb_smem_probe`: x[i] + x[words − 1] with
    i = int(x[0]) mod words."""
    v = x.detach().cpu().reshape(-1)[:words]
    i = int(v[0]) % words
    return float(v[i] + v[words - 1])


def mb_smem_probe(x: torch.Tensor, nbytes: int) -> float | None:
    """MB4: copy ``nbytes`` / 4 words of ``x`` into one block's dynamic
    shared memory (after raising the kernel's limit to ``nbytes``) and read
    one at a dynamic index → the plain version's value, or None where the
    card refused the size."""
    words = nbytes // 4
    if words < 1 or x.numel() < words or x.dtype != torch.float32:
        raise ValueError(f"mb_smem_probe needs {words} float32 words of input")
    if not _check_cuda_or_cpu(x, "mb_smem_probe"):
        return mb_smem_probe_reference(x, words)
    lib, _ = load_microbench()
    out = torch.zeros(1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.rt_mb_smem_probe(x.data_ptr(), nbytes, out.data_ptr(), _stream(x.device))
    if err != 0:
        return None
    LAUNCHES["mb_smem_probe"] += 1
    return float(out[0])


def smem_capacity(x: torch.Tensor, start: int = 48 * 1024, step: int = 1024,
                  stop: int = 256 * 1024) -> dict:
    """Step MB4 from ``start`` bytes by ``step`` until the card refuses →
    {"max_bytes", "checked": each size's output equal to the plain
    version's, "records_4wide_k32", "records_8wide_k32"} (how many records
    of the top of the tree one block's shared memory holds)."""
    best, checked = 0, True
    for nbytes in range(start, stop + 1, step):
        got = mb_smem_probe(x, nbytes)
        if got is None:
            break
        checked &= got == mb_smem_probe_reference(x, nbytes // 4)
        best = nbytes
    return {"max_bytes": best, "checked": bool(checked),
            "records_4wide_k32": best // (4 * REC_WORDS_4WIDE_K32),
            "records_8wide_k32": best // (4 * REC_WORDS_8WIDE_K32)}


# ---- the sweep ---------------------------------------------------------------

@dataclass
class Variant:
    """One variant of MB1–MB3 at a free iteration count n: ``run(n)`` the
    wrapper, ``plain(n)`` its plain version (each → the same dict),
    ``launch(n)`` the bare kernel launch on the card (device outputs, cycles
    last), ``params`` the kernel's other arguments. ``prepare()`` (the walk
    table's successor words) goes before a variant's first call."""

    kernel: str
    label: str
    params: dict
    prepare: Callable[[], None]
    run: Callable[[int], dict]
    plain: Callable[[int], dict]
    launch: Callable[[int], tuple]


def sweep(device, levels=tuple(WALK_SIZES)) -> Iterator[Variant]:
    """Every variant of MB1 over the tables of ``levels`` (keys of
    :data:`WALK_SIZES`; a level's table is made when its first variant is
    reached and shared by its variants), then MB2 and MB3, on ``device``."""
    for level in levels:
        rows = WALK_SIZES[level]
        table = walk_table(rows, device)
        for name, rows_per, chains, mode in WALK_VARIANTS:
            p = dict(level=level, rows=rows, span=rows - rows_per, rows_per=rows_per,
                     chains=chains, mode=mode)
            args = (table, p["span"], rows_per, mode, chains)
            yield Variant("mb_walk", f"{name}/{level}", p,
                          functools.partial(set_walk_span, table, p["span"], chains),
                          functools.partial(mb_walk, *args),
                          functools.partial(mb_walk_reference, *args),
                          functools.partial(_walk_launch, *args))
        del table
    table = walk_table(64, device)
    ones = torch.ones(1024, dtype=torch.float32, device=device)
    for variant in SCALAR_VARIANTS:
        args = (table, ones, variant)
        yield Variant("mb_scalar", variant, {"variant": variant}, lambda: None,
                      functools.partial(mb_scalar, *args),
                      functools.partial(mb_scalar_reference, *args),
                      functools.partial(_scalar_launch, *args))
    ray = torch.tensor(VISIT_RAY, dtype=torch.float32, device=device)
    for slots in (4, 8):
        rec = visit_record(slots, device)
        for regs in (True, False):
            for part, bits in VISIT_PARTS.items():
                yield Variant(
                    "mb_visit", f"{slots}/{'registers' if regs else 'shared'}/{part}",
                    {"slots": slots, "regs": regs, "parts": bits}, lambda: None,
                    lambda n, s=slots, r=regs, b=bits, rc=rec: mb_visit(s, r, b, n, rc, ray),
                    lambda n, s=slots, b=bits, rc=rec: mb_visit_reference(s, b, n, rc, ray),
                    lambda n, s=slots, r=regs, b=bits, rc=rec: _visit_launch(s, r, b, n, rc, ray))


# ---- timing ----------------------------------------------------------------

@dataclass
class PerIteration:
    """Cost of one iteration: ns from CUDA events, cycles from clock64()."""

    ns: float
    cycles: float
    ms_hi: float
    ms_lo: float


def per_iteration(launch, n_hi: int, n_lo: int, reps: int = 3,
                  flush: torch.Tensor | None = None) -> PerIteration:
    """Time ``launch(n)`` (which returns the kernel's outputs, cycles last)
    at ``n_hi`` and ``n_lo`` with CUDA events after two warm-up calls, best
    of ``reps`` each → ns and cycles per iteration of the difference. With
    ``flush`` (a buffer larger than the L2 cache), the buffer is written
    before every timed launch, outside its events, so that the launch finds
    its table in device memory and not in L2."""
    def best_of(n):
        launch(n)
        launch(n)
        times, cyc = [], []
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch(n)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            cyc.append(int(out[-1]))
        return min(times), statistics.median(cyc)

    t_hi, c_hi = best_of(n_hi)
    t_lo, c_lo = best_of(n_lo)
    return PerIteration((t_hi - t_lo) * 1e6 / (n_hi - n_lo), (c_hi - c_lo) / (n_hi - n_lo),
                        t_hi, t_lo)
