"""Multi-card rendering on ``torch.distributed``: image row bands, samples
and cameras sharded over the ranks of a process group.

Torch counterpart of ``raytracer_tpu/parallel/mesh.py``. Rendering is
embarrassingly parallel over pixels: every rank holds the whole scene (the
records, replicated), renders its share, and one collective assembles the
result on every rank, as the JAX package's ``shard_map`` returns a global
array:

* :func:`render_tiles_sharded` — data-parallel pixels: rank r traces rows
  [r·H/n, (r+1)·H/n) of the frame through K1a's ray window
  (``raygen_size`` / ``row_offset``) and shades them; ``all_gather`` gives
  every rank the whole (rgb, t, tri).
* :func:`render_spp_sharded` — samples per pixel: rank r traces the frame
  jittered by ``seeds[r]`` (K1b), and ``all_reduce`` sums the shaded frames;
  the mean is n frames of the single-card progressive stream.
* :func:`render_cameras_sharded` — a batch of C cameras split evenly over the
  ranks, each rank's cameras in one K1c launch, ``all_gather``\\ ed.
* :func:`render_pt_spp_sharded` — path-traced samples: rank r runs
  ``render_pt.pt_sample_frame`` with its own random numbers, the mean comes
  back by ``all_reduce``.

The JAX package has two branches of each: its XLA wide-node traversal (the
CPU default) and the Pallas kernels (``qnodes``). The port has one: the
records through the CUDA kernels on the card, through their plain torch
versions for records on the CPU.

:func:`make_mesh` wraps an initialised process group; :func:`run_ranks`
starts n processes, joins them into a group and runs a function on each: NCCL
among cards, gloo among CPU processes (a ``FileStore`` rendezvous, no TCP
port). Nothing carries on with fewer ranks or on the CPU when a rank or a
card is missing.
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..ops.cuda.traverse import trace_tiles, trace_tiles_batch
from ..ops.shade import shade_lambert
from ..render_pt import pt_sample_frame

__all__ = ["Mesh", "make_mesh", "run_ranks", "render_tiles_sharded", "render_spp_sharded",
           "render_cameras_sharded", "render_pt_spp_sharded"]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process group, this process's rank in it, its size,
    and the device this rank renders on."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device


def make_mesh(n_ranks: int | None = None, device="cuda") -> Mesh:
    """The mesh of the initialised default group's ranks, on ``device`` — a
    card (``"cuda"``: this rank's card, ``cuda:rank % cards``, unless an
    index is given) or the CPU.

    Fails loudly when no group is initialised or it has fewer than
    ``n_ranks`` ranks — a silently truncated mesh makes every sharded
    computation degenerate to one card and "pass". Unlike the JAX package's,
    a mesh spans the whole group (a process is a rank): ``n_ranks`` smaller
    than the group raises too."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError("no process group is initialised: start the ranks with run_ranks or "
                         "torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_ranks is not None and int(n_ranks) != world:
        raise ValueError(f"requested a {n_ranks}-rank mesh but the process group has {world} "
                         "rank(s)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group renders on cards: pass a CUDA device")
    return Mesh(dist.group.WORLD, rank, world, dev)


def _gather_rows(mesh: Mesh, part: torch.Tensor) -> torch.Tensor:
    """Every rank's ``part`` (equal shapes) stacked along dim 0, on every rank."""
    parts = [torch.empty_like(part) for _ in range(mesh.size)]
    dist.all_gather(parts, part.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _mean_over_ranks(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean of every rank's ``x``, on every rank: an all-reduce sum, then
    a division by a tensor (CUDA torch runs a division by a Python scalar as
    a multiply by its reciprocal)."""
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x / torch.full((), float(mesh.size), dtype=x.dtype, device=x.device)


def _check_records(qnodes: torch.Tensor, mesh: Mesh) -> None:
    if qnodes.device != mesh.device:
        raise ValueError(f"records on {qnodes.device}, this rank renders on {mesh.device}")


def _rank_seed(seeds, mesh: Mesh) -> int:
    seeds = [int(s) for s in torch.as_tensor(seeds).reshape(-1).tolist()]
    if len(seeds) != mesh.size:
        raise ValueError(f"{len(seeds)} seeds for a {mesh.size}-rank mesh: give one per rank")
    return seeds[mesh.rank]


def render_tiles_sharded(qnodes: torch.Tensor, tris: torch.Tensor, cam_pos, cam_quat,
                         width: int, height: int, mesh: Mesh, fov_degrees: float = 70.0,
                         leaf_k: int = 1):
    """Full frame with pixel rows sharded over the mesh → (rgb (H, W, 3) f32,
    t (H, W), tri (H, W) int32) on every rank.

    ``height`` must divide evenly by the mesh size (callers pad). Each rank
    traces only its band, with the full frame's rays (K1a's window); the
    records of ``tris`` are replicated, ``tris`` itself is not read."""
    _check_records(qnodes, mesh)
    if height % mesh.size:
        raise ValueError(f"height {height} is not a multiple of the mesh size {mesh.size}: pad it")
    band = height // mesh.size
    t, nx, ny, nz, tri = trace_tiles(qnodes, cam_pos, cam_quat, width, band, fov_degrees,
                                     leaf_k=leaf_k, raygen_size=(width, height),
                                     row_offset=mesh.rank * band)
    rgb = shade_lambert(torch.stack([nx, ny, nz], dim=-1), tri >= 0)
    return tuple(_gather_rows(mesh, p) for p in (rgb, t, tri))


def render_spp_sharded(qnodes: torch.Tensor, tris: torch.Tensor, cam_pos, cam_quat, seeds,
                       width: int, height: int, mesh: Mesh, fov_degrees: float = 70.0,
                       leaf_k: int = 1) -> torch.Tensor:
    """Samples per pixel across ranks: rank r traces the frame at the
    ``subpixel_hash01`` offsets of ``seeds[r]`` (K1b, the single-card
    progressive stream's frame of that seed) and shades it; the mean over
    the ranks (H, W, 3) comes back on every rank."""
    _check_records(qnodes, mesh)
    _, nx, ny, nz, tri = trace_tiles(qnodes, cam_pos, cam_quat, width, height, fov_degrees,
                                     leaf_k=leaf_k, jitter=True,
                                     jitter_seed=_rank_seed(seeds, mesh))
    return _mean_over_ranks(mesh, shade_lambert(torch.stack([nx, ny, nz], dim=-1), tri >= 0))


def render_cameras_sharded(qnodes: torch.Tensor, tris: torch.Tensor, cam_pos_batch,
                           cam_quat_batch, width: int, height: int, mesh: Mesh,
                           fov_degrees: float = 70.0, leaf_k: int = 1) -> torch.Tensor:
    """A batch of C cameras ((C, 3) positions, (C, 4) quaternions, host
    values) split evenly over the ranks — C must be a multiple of the mesh
    size — each rank's cameras in one K1c launch → rgb (C, H, W, 3) on every
    rank."""
    _check_records(qnodes, mesh)
    pos = torch.as_tensor(cam_pos_batch, dtype=torch.float32).cpu()
    quat = torch.as_tensor(cam_quat_batch, dtype=torch.float32).cpu()
    if pos.shape[0] % mesh.size:
        raise ValueError(f"{pos.shape[0]} cameras do not split evenly over {mesh.size} ranks")
    per = pos.shape[0] // mesh.size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    _, nx, ny, nz, tri = trace_tiles_batch(qnodes, pos[mine], quat[mine], width, height,
                                           fov_degrees, leaf_k=leaf_k)
    return _gather_rows(mesh, shade_lambert(torch.stack([nx, ny, nz], dim=-1), tri >= 0))


def render_pt_spp_sharded(qnodes: torch.Tensor, tris: torch.Tensor, cam_pos, cam_quat, seeds,
                          width: int, height: int, mesh: Mesh, bounces: int = 2,
                          fov_degrees: float = 70.0, compact: bool = False, leaf_k: int = 1,
                          tile_primary: bool = False, uniforms=None) -> torch.Tensor:
    """Path-traced samples (NEE + bounces) across ranks: rank r runs
    ``pt_sample_frame`` with a ``torch.Generator`` on its device seeded with
    ``seeds[r]`` — or, where ``uniforms`` (one mapping per rank, indexed by
    rank) is given, with those draws — and the mean (H, W, 3) comes back on
    every rank. ``tile_primary`` traces each camera wave through K1b;
    ``compact=True`` raises, as ``pt_sample_frame`` does."""
    _check_records(qnodes, mesh)
    seed = _rank_seed(seeds, mesh)
    gen = None if uniforms is not None else torch.Generator(device=mesh.device).manual_seed(seed)
    sample = pt_sample_frame(qnodes, tris, cam_pos, cam_quat, width, height, bounces=bounces,
                             fov_degrees=fov_degrees, leaf_k=leaf_k, tile_primary=tile_primary,
                             generator=gen, compact=compact,
                             uniforms=None if uniforms is None else uniforms[mesh.rank])
    return _mean_over_ranks(mesh, sample)


# -- starting ranks ---------------------------------------------------------------


def _rank_main(fn, rank: int, n: int, backend: str, device: str, store_path: str,
               timeout_s: float, args: tuple, results) -> None:
    """One spawned rank: join the group through the file store, run
    ``fn(mesh, *args)``, send back (rank, "ok", value) or (rank, "error",
    traceback); leave the group."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout_s))
        try:
            results.put((rank, "ok", fn(make_mesh(n, device), *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — the rank's boundary: its failure goes to the parent
        results.put((rank, "error", traceback.format_exc()))


def run_ranks(fn, n: int, args: tuple = (), *, device="cuda", backend: str | None = None,
              timeout: float = 60.0) -> list:
    """Start ``n`` processes (spawned), join them into one process group and
    return ``[fn(mesh, *args) for each rank]``, in rank order.

    ``fn`` must be importable by a fresh interpreter (a module-level
    function) and return host values: they are pickled back. ``device`` is
    where each rank renders (each rank's own card for ``"cuda"``, or
    ``"cuda:0"`` for ranks that share one); ``backend`` defaults to NCCL on
    cards and gloo on the CPU; NCCL with more ranks than visible cards
    raises, as do a missing card or a rank that fails or does not answer
    within ``timeout`` seconds (the group's timeout too). The rendezvous is a
    ``FileStore`` in a temporary directory: no TCP port, so concurrent runs
    cannot collide."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            raise RuntimeError(f"device {dev} requested but no CUDA device is available")
        if backend == "nccl" and dev.index is None and n > cards:
            raise ValueError(f"NCCL over {n} ranks needs {n} cards, {cards} visible")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, n, backend, str(device),
                                                      store_path, timeout, args, results),
                             daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        out, errors = {}, []
        try:
            for _ in range(n):
                try:
                    rank, status, value = results.get(timeout=timeout)
                except queue.Empty:
                    errors.append(f"no answer within {timeout} s from ranks "
                                  f"{sorted(set(range(n)) - set(out))}")
                    break
                if status == "ok":
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
    if errors:
        raise RuntimeError("run_ranks failed: " + "\n".join(errors))
    return [out[r] for r in range(n)]
