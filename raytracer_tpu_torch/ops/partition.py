"""Stable bucket partition of small integer keys: the wave-compaction
permutation of ``render_pt`` under ``compact_impl="partition"``.

Torch counterpart of ``raytracer_tpu/ops/partition.py``, with the same
results: :func:`bucket_positions` gives each element's destination under a
stable ascending partition of keys in [0, B), :func:`bucket_partition_perm`
the permutation that applies it (equal to a stable argsort of the keys).

The route differs. The JAX package ranks every element inside a block of
``block`` elements with a triangular matmul over a one-hot of all R keys
(R·B f32: 2 GiB at 1920×1080 with B = 256). Here the ranks are exact
integer counts that never materialise more than R·32 bytes:

  position[i] = base[k_i] + before[s_i, k_i] + rank[i]

with ``s_i`` the sub-block of 32 elements that holds element i, ``rank``
its rank among the equal keys of its sub-block (a 32 × 32 comparison a
sub-block), ``before[s, k]`` the count of key k in all earlier sub-blocks
(per-sub-block counts by one scatter-add into a (B, R / 32) int32 table,
then an exclusive cumulative sum along its rows; a scan along the other
axis runs one thread a column on a CUDA card, 27 ms at 1080p on an H100)
and ``base[k]`` the count of all smaller keys (an exclusive cumulative sum
over the B totals). A stable partition is unique, so ``block`` changes no
result; it is taken for the JAX signature. Nothing is read back to the host.
"""

from __future__ import annotations

import torch

__all__ = ["bucket_positions", "bucket_partition_perm"]

_SUB = 32  # elements ranked against each other by direct comparison


def bucket_positions(keys: torch.Tensor, num_buckets: int, block: int = 256) -> torch.Tensor:
    """Destination of each element (int64 (R,)) under a stable ascending
    partition of ``keys`` (integers in [0, num_buckets)), on their device."""
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    if num_buckets < 1 or block < 1:
        raise ValueError("num_buckets and block must be positive")
    r = keys.shape[0]
    dev = keys.device
    b = num_buckets + 1  # padding takes bucket num_buckets, past every real key: it moves none
    kp = torch.cat([keys.to(torch.int64),
                    torch.full(((-r) % _SUB,), num_buckets, dtype=torch.int64, device=dev)])
    nsub = kp.shape[0] // _SUB
    ks = kp.reshape(nsub, _SUB)
    earlier = torch.ones(_SUB, _SUB, dtype=torch.bool, device=dev).tril(-1)
    rank = ((ks[:, :, None] == ks[:, None, :]) & earlier).sum(dim=2)       # (nsub, 32)
    # counts[k, s] of key k in sub-block s, laid out so that the scan over
    # the sub-blocks runs along the contiguous axis
    slot = ks * nsub + torch.arange(nsub, device=dev)[:, None]
    counts = torch.zeros(b * nsub, dtype=torch.int32, device=dev).scatter_add_(
        0, slot.reshape(-1), torch.ones(nsub * _SUB, dtype=torch.int32, device=dev))
    counts = counts.reshape(b, nsub)
    upto = counts.cumsum(dim=1, dtype=torch.int32)
    before = (upto - counts).reshape(-1)                                    # (b · nsub,)
    total = upto[:, -1].to(torch.int64)
    base = total.cumsum(dim=0) - total                                      # (b,)
    pos = base[ks] + before[slot] + rank
    return pos.reshape(-1)[:r]


def bucket_partition_perm(keys: torch.Tensor, num_buckets: int, block: int = 256) -> torch.Tensor:
    """The permutation (int64 (R,)) with ``keys[perm]`` stably ascending:
    ``x[perm]`` gathers payloads into partitioned order exactly as
    ``x[torch.argsort(keys, stable=True)]`` does."""
    pos = bucket_positions(keys, num_buckets, block)
    r = keys.shape[0]
    return torch.empty(r, dtype=torch.int64, device=keys.device).scatter_(
        0, pos, torch.arange(r, device=keys.device))
