"""The microbenchmark kernels' plain versions (raytracer_tpu_torch/ops/cuda/
microbench.py) against the TPU microbenchmarks they replace, run as Pallas
kernels in interpret mode on the CPU, and against closed forms where the
checksum is the port's own.

Tolerance: exact everywhere. The checksums are sums in one fixed order (or
XORs), which the plain versions take in that same order with the same f32
roundings.

``tools/mb_kernel2.py`` and ``tools/mb_smem_probe.py`` run their benchmarks
when imported, so their kernel functions are taken out of the file with
``ast`` and only those definitions are executed.
"""

import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytracer_tpu_torch.ops.cuda import microbench as mb
from raytracer_tpu_torch.ops.trace import moller_trumbore

TOOLS = Path(__file__).resolve().parents[1] / "tools"
ROWS, N = 64, 10


def load_mb_kernel():
    spec = importlib.util.spec_from_file_location("mb_kernel_tpu", TOOLS / "mb_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_defs(name: str, wanted) -> dict:
    """Execute only the function definitions ``wanted`` (top level, or nested
    in a top-level function) of ``tools/<name>``; nothing else of the file
    runs."""
    tree = ast.parse((TOOLS / name).read_text())
    defs = [node for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef) and node.name in wanted]
    scope = {"jax": jax, "jnp": jnp, "np": np, "pl": pl, "pltpu": pltpu, "REC": 128}
    exec(compile(ast.Module(body=defs, type_ignores=[]), name, "exec"), scope)
    return {k: scope[k] for k in wanted}


def tpu_table(rows: int = ROWS) -> jax.Array:
    return jnp.arange(rows * 128, dtype=jnp.float32).reshape(rows, 128) * 1e-6


def run_interpret(kernel, scratch, n: int) -> np.ndarray:
    """The TPU scripts' one-program launch, in interpret mode."""
    out = pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        scratch_shapes=scratch, interpret=True,
    )(jnp.array([n], jnp.int32), tpu_table())
    return np.asarray(out)


def port_table(span: int, chains: int = 1) -> torch.Tensor:
    t = mb.walk_table(ROWS, "cpu")
    mb.set_walk_span(t, span, chains)
    return t


def test_walk_table_is_the_tpu_table_but_word_0():
    t = mb.walk_table(ROWS, "cpu")
    assert np.array_equal(t.numpy(), np.asarray(tpu_table()))
    mb.set_walk_span(t, ROWS - 4)
    succ = t[:, 0].view(torch.int32)
    assert torch.equal(succ, (torch.arange(ROWS) + 97) % (ROWS - 4))
    assert np.array_equal(t[:, 1:].numpy(), np.asarray(tpu_table())[:, 1:])
    mb.set_walk_span(t, ROWS - 4, chains=4)  # a chain's successor, 4 chains interleaved
    assert torch.equal(t[:, 0].view(torch.int32), (torch.arange(ROWS) + 4 * 97) % (ROWS - 4))


def test_loop_and_reduce_match_the_pallas_kernels():
    k = load_mb_kernel()
    ones = torch.ones(1024)
    table = port_table(ROWS)
    got = run_interpret(k.k_loop, [pltpu.SMEM((2,), jnp.int32)], N)
    ref = mb.mb_scalar(table, ones, "loop", N)
    assert got[0, 0] == np.float32(ref["a_int"]) == N * (N - 1) // 2
    got = run_interpret(k.k_reduce, [pltpu.SMEM((2,), jnp.int32)], N)
    ref = mb.mb_scalar(table, ones, "reduce", N)
    assert ref["a_int"] == 1024 * N
    assert got[0, 0] == np.float32(np.float32(ref["a_int"]) + np.float32(ref["v"]))


@pytest.mark.parametrize("name,rows_per,kw,mode,chains", [
    ("dma512", 1, {}, 0, 1), ("dma2k", 4, {}, 0, 1), ("dma8k", 16, {}, 0, 1),
    ("dma2k_pipe", 4, {"pipelined": True}, 2, 1), ("dma2k_x4", 4, {"streams": 4}, 0, 4),
    ("dma2k_vec", 4, {"vec_ops": 40}, 1, 1)])
def test_walk_matches_make_k_dma(name, rows_per, kw, mode, chains):
    """make_k_dma's checksum a (+ v with the vector rounds) on the TPU
    script's variants, against the plain walk over the same rows."""
    k = load_mb_kernel()
    nslots = max(2 if kw.get("pipelined") else 1, kw.get("streams", 1))
    scratch = [pltpu.VMEM((nslots, rows_per, 128), jnp.float32),
               pltpu.SemaphoreType.DMA((nslots,)), pltpu.SMEM((2,), jnp.int32)]
    got = run_interpret(k.make_k_dma(rows_per, **kw), scratch, N)
    span = ROWS - rows_per
    ref = mb.mb_walk(port_table(span, chains), span, rows_per, mode, chains, N)
    assert got[0, 0] == np.float32(np.float32(ref["a"]) + np.float32(ref["v"])), name
    if mode == 1:
        assert ref["v"] > 0


@pytest.mark.parametrize("kernel,mode", [("k_dma_smem_ser", 0), ("k_dma_smem_pipe", 2)])
def test_walk_matches_the_smem_dma_kernels(kernel, mode):
    """mb_kernel2.py's 512-byte walks (rows (i · 97) mod rows)."""
    fn = kernel_defs("mb_kernel2.py", [kernel])[kernel]
    slots = 2 if mode == 2 else 1
    scratch = [pltpu.SMEM((slots, 128), jnp.float32), pltpu.SemaphoreType.DMA((slots,))]
    got = run_interpret(fn, scratch, N)
    ref = mb.mb_walk(port_table(ROWS), ROWS, 1, mode, 1, N)
    assert got[0, 0] == np.float32(ref["a"])


def test_walk_checksums_against_numpy():
    """The dependent walk's XOR of every loaded word, and its a, by a
    direct numpy walk that follows word 0 of each row."""
    span, rows_per, chains = ROWS - 4, 4, 2
    table = port_table(span, chains)
    t = table.numpy()
    rows = [(s * 97) % span for s in range(chains)]
    a, x = np.float32(0.0), 0
    for _ in range(N):
        for s in range(chains):
            for r in range(rows_per):
                x ^= int(np.bitwise_xor.reduce(t[rows[s] + r].view(np.uint32)))
            a = np.float32(a + t[rows[s], 1])
            rows[s] = int(t[rows[s], 0:1].view(np.int32)[0])
    ref = mb.mb_walk_reference(table, span, rows_per, 0, chains, N)
    assert ref["a"] == float(a) and ref["xor"] == x
    assert mb.mb_walk_reference(table, span, rows_per, 2, 1, N)["xor"] == 0


def test_scalar_variants_against_closed_forms():
    table, ones = port_table(ROWS), torch.ones(1024)
    rec = table.reshape(-1)[:64].numpy()
    s = np.float32(0.0)
    for k in range(24):
        s = np.float32(s + rec[(k * 5 + 1) % 64])
    a = np.float32(0.0)
    for _ in range(N):
        a = np.float32(a + s)
    for v in ("smem24", "l1x24"):
        assert mb.mb_scalar(table, ones, v, N)["a"] == float(a)
    b = np.float32(0.0)
    for i in range(N):
        b = np.float32(b + rec[i % 32])
    for v in ("shfl_bcast", "smem_bcast", "l1_bcast"):
        assert mb.mb_scalar(table, ones, v, N)["a"] == float(b)
    big = 1 << 17
    assert mb.mb_scalar(table, ones, "loop", big)["a_int"] == \
        int(np.int32(np.int64(big) * (big - 1) // 2 % (1 << 32)))
    with pytest.raises(ValueError):
        mb.mb_scalar(table, ones, "mxu", N)


def test_smem_probe_matches_the_pallas_kernel():
    """mb_smem_probe.py's kern at 64 KB (128 rows) on a seeded input,
    against the plain read (the capacity itself is a question for the
    card)."""
    rows = 128
    kern = kernel_defs("mb_smem_probe.py", ["kern"])["kern"]
    kern.__globals__["rows"] = rows
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 500, size=(rows, 128)).astype(np.float32)
    got = pl.pallas_call(kern, in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
                         out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
                         out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
                         interpret=True)(jnp.asarray(x))
    # the TPU kernel reads x[i, 1] (row i) and x[rows - 1, 127]; the port's
    # reads words i and words - 1 of the flat buffer: give it those words
    i = int(x[0, 0]) % rows
    flat = np.zeros(rows * 128, np.float32)
    flat[0], flat[int(x[0, 0]) % flat.size] = x[0, 0], x[i, 1]
    flat[-1] = x[rows - 1, 127]
    ref = mb.mb_smem_probe(torch.from_numpy(flat), flat.size * 4)
    assert np.float32(ref) == np.asarray(got)[0, 0]
    cap = mb.smem_capacity(torch.from_numpy(flat), start=4096, step=4096, stop=16384)
    assert cap["checked"] and cap["max_bytes"] == 16384


@pytest.mark.parametrize("slots", [4, 8])
def test_visit_reference_parts(slots):
    """MB3's plain visit: the Möller–Trumbore part gives the port's
    moller_trumbore t of the last ray; the full visit's checksum differs
    from each part alone and is the same for either record source."""
    rec, ray = mb.visit_record(slots, "cpu"), torch.tensor(mb.VISIT_RAY)
    only_mt = mb.mb_visit(slots, True, mb.VISIT_PARTS["mt"], 1, rec, ray)
    tri = rec[8 * slots:8 * slots + 9].reshape(3, 3)
    t, ok = moller_trumbore(ray[None, :3], ray[None, 3:], tri[0][None], tri[1][None],
                            tri[2][None])
    assert bool(ok[0]) and only_mt["best"] == float(t[0])
    full = mb.mb_visit(slots, False, mb.VISIT_PARTS["visit"], 50, rec, ray)
    assert full == mb.mb_visit(slots, True, mb.VISIT_PARTS["visit"], 50, rec, ray)
    parts = {p: mb.mb_visit(slots, True, v, 50, rec, ray)["acc"]
             for p, v in mb.VISIT_PARTS.items()}
    assert len(set(parts.values())) == len(parts)


def test_sweep_lists_every_variant_on_the_cpu():
    """The sweep that chip_microbench.py and chip_smoke.py time: every
    variant once, its wrapper (the plain version on the CPU) and its plain
    version the same dict; the bare launch needs a CUDA tensor."""
    variants = list(mb.sweep("cpu", levels=("L1",)))
    assert [v.kernel for v in variants] == (["mb_walk"] * len(mb.WALK_VARIANTS)
                                            + ["mb_scalar"] * len(mb.SCALAR_VARIANTS)
                                            + ["mb_visit"] * 4 * len(mb.VISIT_PARTS))
    assert len({v.label for v in variants}) == len(variants)
    for v in variants:
        v.prepare()
        got = v.run(7)
        assert got == v.plain(7) and set(got) == set(v.plain(3)), v.label
    for i in (0, len(mb.WALK_VARIANTS), -1):
        with pytest.raises(ValueError, match="CUDA"):
            variants[i].launch(7)
