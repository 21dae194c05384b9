"""The work a traversal of the renderer's records needs: node visits and
Möller–Trumbore tests, counted by a plain walk of the records.

A frozen copy of the plain version's counter (``TraversalCounts`` over
``_traverse`` in ``raytracer_tpu_torch/ops/cuda/traverse.py``): one stack
a ray, a visit for each pop that passes the cull against the ray's best t,
its w child boxes slab-tested, every triangle of a posted leaf slot tested,
the passing children pushed far to near (64 entries at most). An any-hit ray
stops at its first accepted triangle. It reads the records' layout (f32 words,
w = 4 or 8 child slots, K triangles a leaf):

  [0 : 6w]   child boxes; [6w : 7w] child refs (≥ 0 internal, −(first + 1)
  a leaf, −2^28 empty); [7w : 8w] triangle counts of leaves;
  [8w + (kK + j)·12 : +12] slot k's j-th triangle (v0, e1, e2, e1 × e2);
  [8w + 12wK + kK + j] its triangle id; rows padded to 128 words.

Operations: 25·w a visit (w slab tests) and 54 a test. Bytes: the distinct
headers (32·w bytes) and triangle records (48 bytes) the counted rays read,
each once. Counted on a seeded subset of a launch's rays and scaled to all
of them, so the count is the same whatever kernel runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

__all__ = ["rec_layout", "record_width", "traverse", "Work", "FLOPS_PER_SLOT",
           "FLOPS_PER_TEST"]

FLOPS_PER_SLOT = 25
FLOPS_PER_TEST = 54
_EMPTY = -float(1 << 28)
_STACK = 64
_INF = 1e30
_EPS = 1e-7


def rec_layout(leaf_k: int, width: int) -> tuple[int, int, int]:
    """(first triangle word, first id word, words a record)."""
    vbase = 8 * width
    ibase = vbase + width * 12 * leaf_k
    return vbase, ibase, -(-(ibase + width * leaf_k) // 128) * 128


def record_width(leaf_k: int, words: int) -> int:
    """The child slots (4 or 8) of records ``words`` long."""
    for width in (4, 8):
        if rec_layout(leaf_k, width)[2] == words:
            return width
    raise ValueError(f"records of {words} words match no width at K = {leaf_k}")


@dataclass
class Work:
    """Counts of one launch's counted rays, to be scaled to ``scale`` times as many."""
    width: int
    rays: int = 0
    visits: int = 0
    tests: int = 0
    nodes: list = field(default_factory=list)
    tris: list = field(default_factory=list)

    def flops(self) -> float:
        return float(self.visits * FLOPS_PER_SLOT * self.width + self.tests * FLOPS_PER_TEST)

    def record_bytes(self) -> int:
        def distinct(parts):
            return torch.unique(torch.cat(parts)).numel() if parts else 0
        return 32 * self.width * distinct(self.nodes) + 48 * distinct(self.tris)


def _mt(o, d, v0, e1, e2):
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    px = dy * e2[..., 2] - dz * e2[..., 1]
    py = dz * e2[..., 0] - dx * e2[..., 2]
    pz = dx * e2[..., 1] - dy * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    inv = torch.where(det == 0.0, torch.ones_like(det), det).reciprocal()
    s = o - v0
    u = inv * (s[..., 0] * px + s[..., 1] * py + s[..., 2] * pz)
    qx = s[..., 1] * e1[..., 2] - s[..., 2] * e1[..., 1]
    qy = s[..., 2] * e1[..., 0] - s[..., 0] * e1[..., 2]
    qz = s[..., 0] * e1[..., 1] - s[..., 1] * e1[..., 0]
    v = inv * (dx * qx + dy * qy + dz * qz)
    t = inv * (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz)
    ok = (det.abs() >= _EPS) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > _EPS)
    return t, ok


def traverse(qn: torch.Tensor, o: torch.Tensor, d: torch.Tensor, leaf_k: int,
             any_hit: bool, work: Work):
    """Walk rays o, d (R, 3) through records ``qn`` (M, words), adding to
    ``work`` → (t (R,), unit normal e1 × e2 of the hit (R, 3), hit (R,) bool)."""
    dev = qn.device
    r = d.shape[0]
    w = record_width(leaf_k, qn.shape[1])
    wk = w * leaf_k
    vbase = rec_layout(leaf_k, w)[0]
    inv = torch.where(d.abs() > 1e-8, d.reciprocal(), torch.full_like(d, _INF))
    best = torch.full((r,), _INF, dtype=torch.float32, device=dev)
    nrm = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    hit_any = torch.zeros((r,), dtype=torch.bool, device=dev)
    stack_n = torch.zeros((r, _STACK), dtype=torch.int64, device=dev)
    stack_d = torch.zeros((r, _STACK), dtype=torch.float32, device=dev)
    sp = torch.zeros((r,), dtype=torch.int64, device=dev)
    lanes = torch.arange(leaf_k, device=dev, dtype=torch.float32)
    work.rays += r
    while True:
        live = torch.nonzero(sp >= 0).squeeze(1)
        if live.numel() == 0:
            break
        top = sp[live]
        node, key = stack_n[live, top], stack_d[live, top]
        sp[live] = top - 1
        keep = key < best[live]
        rays, node = live[keep], node[keep]
        if rays.numel() == 0:
            continue
        work.visits += rays.numel()
        work.nodes.append(torch.unique(node))
        hdr = qn[node, 0:8 * w]
        cur = best[rays]
        ro, ri = o[rays], inv[rays]
        boxes = hdr[:, 0:6 * w].reshape(-1, w, 6)
        t1 = (boxes[..., 0:3] - ro[:, None, :]) * ri[:, None, :]
        t2 = (boxes[..., 3:6] - ro[:, None, :]) * ri[:, None, :]
        tmin = torch.minimum(t1, t2).amax(dim=-1)
        tmax = torch.maximum(t1, t2).amin(dim=-1)
        inside = (tmax >= tmin.clamp_min(0.0)) & (tmin < cur[:, None])
        refs, cnt = hdr[:, 6 * w:7 * w], hdr[:, 7 * w:8 * w]
        leaf = inside & (refs < 0.0) & (refs > _EMPTY)
        mrow = torch.nonzero(leaf.any(dim=1)).squeeze(1)
        done = None
        if mrow.numel():
            recs = qn[node[mrow], vbase:vbase + 12 * wk].reshape(-1, w, leaf_k, 12)
            gate = leaf[mrow][:, :, None] & (lanes < cnt[mrow][:, :, None])
            tt, ok = _mt(o[rays[mrow]][:, None, None, :], d[rays[mrow]][:, None, None, :],
                         recs[..., 0:3], recs[..., 3:6], recs[..., 6:9])
            c = cur[mrow]
            ok = (gate & ok & (tt < c[:, None, None])).reshape(-1, wk)
            tt = tt.reshape(-1, wk)
            if any_hit:
                j = torch.argmax(ok.to(torch.uint8), dim=1)
                upd = ok.any(dim=1)
                tbest = torch.zeros_like(c)
            else:
                tt = torch.where(ok, tt, torch.full_like(tt, _INF))
                j = torch.argmin(tt, dim=1)
                tbest = tt.gather(1, j[:, None])[:, 0]
                upd = tbest < c
            tested = gate.reshape(-1, wk)
            if any_hit:
                last = torch.where(upd, j, torch.full_like(j, wk - 1))
                tested = tested & (torch.arange(wk, device=dev) <= last[:, None])
            cand = torch.nonzero(tested)
            work.tests += cand.shape[0]
            work.tris.append(torch.unique(node[mrow][cand[:, 0]] * wk + cand[:, 1]))
            if bool(upd.any()):
                urow, uj = mrow[upd], j[upd]
                g = recs.reshape(-1, wk, 12)[upd, uj, 9:12]
                dst = rays[urow]
                best[dst] = tbest[upd]
                nrm[dst] = g / torch.sqrt((g * g).sum(-1, keepdim=True))
                hit_any[dst] = True
                if any_hit:
                    done = urow
        push = inside & (refs >= 0.0)
        if done is not None:
            push[done] = False
        skey = torch.where(push, tmin, torch.full_like(tmin, -torch.inf))
        _, order = torch.sort(skey, dim=1, descending=True, stable=True)
        for i in range(w):
            slot = order[:, i]
            can = push.gather(1, slot[:, None])[:, 0] & (sp[rays] < _STACK - 1)
            if not bool(can.any()):
                continue
            cr, cs = rays[can], slot[can]
            top = sp[cr] + 1
            sp[cr] = top
            stack_n[cr, top] = refs[can, cs].to(torch.int64)
            stack_d[cr, top] = tmin[can, cs]
        if done is not None:
            sp[rays[done]] = -1
    return best, nrm, hit_any
