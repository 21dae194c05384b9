"""Progressive path tracing: one 1-spp sample per call, and the running mean.

Torch counterpart of ``raytracer_tpu/render_pt.py`` (``pt_sample_frame``,
``accumulate``), with the same light model:

* Lambert BRDF ρ/π with ρ = (0.9, 0.7, 0.3); a directional sun along
  normalize(1, 1.5, 1) scaled so that direct light = ρ·max(n·l, 0); an
  ambient sky of radiance 0.15 for rays after the camera wave; camera rays
  that miss show the 0.01 background.
* Sampling: jittered camera rays, cosine-hemisphere bounces, next-event
  estimation (NEE: an any-hit shadow ray toward the sun) at every hit, a
  fixed bounce budget.
* Waves: each bounce traces every lane as one batch. With records, the
  camera wave goes through the jittered tile kernel K1b
  (``tile_primary``; then the kernel ``ops.cuda.camera.camera_lanes``
  puts its planes, the rays' directions and the turned normals in lane
  order; both read the camera and the jitter seed from the sample's
  camera row, :func:`camera_block`, on the device) or the ray-buffer
  kernel K2a; the bounce waves through
  K2a with the live paths as the ``active`` mask; the NEE waves through
  the any-hit kernel K2b with ``active`` = hit and n·l > 0. Inactive lanes
  are not read and their results are never used, so the mask changes no
  pixel. ``brute`` traces every wave by brute force instead.
* Shading: after each closest-hit wave ``ops.cuda.wave.wave_hit`` turns the
  normals, adds the miss term and sets up the shadow rays; after each
  shadow wave ``wave_bounce`` adds the direct light and draws the bounce,
  and on the last wave ``wave_last`` adds the sky term and returns the
  image. Each is one CUDA kernel on the card and its plain torch version on
  the CPU, the same numbers bit for bit.
* Lanes start in 32×32 tile-block order (:mod:`.ops.lanes`): it keeps
  a warp's rays neighbours, and it is the lane order of the JAX package, so
  its random numbers line up lane for lane. Without compaction they stay in
  it to the end. With ``compact=True`` every wave but the last is followed
  by the JAX package's wavefront compaction: the lanes are re-sorted, live
  paths first, grouped by direction octant and then by the Morton code of
  the origin (:func:`_compaction_perm`), and a lane → pixel index that
  travels with them scatters the radiance to its pixels at the end.

Random numbers come from an explicit ``torch.Generator`` or, for tests that
hold the port against the JAX package, from a ``uniforms`` mapping that
injects the JAX package's draws (see :func:`pt_sample_frame`).

A sample as ``PathTracer.render_progressive`` runs it on the card is one
CUDA graph (:class:`SampleGraphs`): the sample and its ``accumulate``
captured once and replayed, with the camera, the jitter seed and the
mean's sample count read from a uniform block on the device
(:func:`uniform_block`) and the draws from a generator registered with the
graph, so that the host issues one copy and one graph launch a sample.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Mapping

import torch

from .ops.camera import primary_dirs, to_device
from .ops.cuda.camera import camera_lanes
from .ops.cuda.traverse import CAMERA_ROW, LAUNCHES, camera_row, trace_rays, trace_tiles_row
from .ops.cuda.wave import blocked, wave_bounce, wave_hit, wave_last
from .ops.lanes import TILE, img_to_lanes, lanes_to_img
# the name benchmark/tests/test_bench_reference.py imports the lane order by
from .ops.lanes import lane_of_pixel as _lane_of_pixel  # noqa: F401
from .ops.morton import expand_bits10
from .ops.partition import bucket_partition_perm
from .ops.shade import MISS_COLOR, triangle_normals
from .ops.trace import trace_rays_brute
from .utils.profiling import count, counting, span, tracing

__all__ = ["pt_sample_frame", "accumulate", "compaction_key", "COMPACT_IMPLS", "TILE",
           "jitter_seed", "camera_block", "uniform_block", "COUNT_COLUMN",
           "sample_graph_eligible", "SampleGraph", "SampleGraphs"]

_BASE = (0.9, 0.7, 0.3)
_SUN_DIR = (1.0, 1.5, 1.0)
_SKY = 0.15
_EPS_OFFSET = 1e-4
_MAX_PSEED = 1 << 22


def _unit_sun() -> tuple[float, float, float]:
    """The sun's unit direction, as f32 values."""
    sun = torch.tensor(_SUN_DIR, dtype=torch.float32)
    return tuple((sun / torch.linalg.vector_norm(sun)).tolist())


_SUN = _unit_sun()
_SUN_DIRS = {}  # device → the shadow waves' directions of its last lane count


def _sun_dirs(device, r: int) -> torch.Tensor:
    """(r, 3) copies of the sun's direction on ``device``: the shadow rays'
    directions, made once for each device and lane count."""
    key = str(device)
    if key not in _SUN_DIRS or _SUN_DIRS[key].shape[0] != r:
        _SUN_DIRS[key] = to_device(_SUN, device).expand(r, 3).contiguous()
    return _SUN_DIRS[key]


def jitter_seed(initial_seed: int) -> int:
    """The jitter seed ``pseed`` of a sample whose generator was seeded with
    ``initial_seed``: drawn on the host from a CPU generator of that seed, so
    that a sample never waits for the device's previous work."""
    host = torch.Generator(device="cpu").manual_seed(initial_seed)
    return int(torch.randint(0, _MAX_PSEED, (), generator=host))


class _Draws:
    """The random numbers of one sample, in the order of the JAX package's
    ``jax.random.split(key, 2 + 2·bounces)``: the jitter (``pseed``, or the
    per-pixel ``jx``/``jy``), then ``u1[b]``/``u2[b]`` per bounce. Taken from
    ``uniforms`` where it holds them, else drawn from ``generator``."""

    def __init__(self, uniforms: Mapping | None, generator: torch.Generator | None, device):
        if uniforms is None and generator is None:
            raise ValueError("pt_sample_frame needs a torch.Generator or injected uniforms")
        self.uniforms = uniforms or {}
        self.generator = generator
        self.device = device

    def _rand(self, shape) -> torch.Tensor:
        if self.generator is None:
            raise ValueError("uniforms lack a draw and no generator was given")
        return torch.rand(shape, generator=self.generator, device=self.device)

    def _given(self, name: str, shape, b: int | None = None) -> torch.Tensor:
        if name not in self.uniforms:
            return self._rand(shape)
        u = self.uniforms[name] if b is None else self.uniforms[name][b]
        u = torch.as_tensor(u, dtype=torch.float32).to(self.device)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms[{name!r}] has shape {tuple(u.shape)}, want {shape}")
        return u

    def pseed(self) -> int:
        """The jitter seed, a host int the kernel takes as an argument
        (:func:`jitter_seed` of the generator's initial seed)."""
        if "pseed" in self.uniforms:
            return int(self.uniforms["pseed"])
        if self.generator is None:
            raise ValueError("uniforms lack 'pseed' and no generator was given")
        return jitter_seed(self.generator.initial_seed())


    def jitter(self, height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self._given("jx", (height, width)), self._given("jy", (height, width))

    def bounce(self, b: int, r: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self._given("u1", (r,), b), self._given("u2", (r,), b)


def _trace(qnodes, tris, o, d, brute: bool, leaf_k: int, active, scattered: bool = False,
           ordered: bool = True):
    """One closest-hit wave → (t, tri, the normals' three planes, not yet
    turned to face the rays). ``scattered``: the active lanes are the hits
    of random bounce rays (the kernel then compacts them); ``ordered``:
    near-first traversal order."""
    if brute:
        t, tri = trace_rays_brute(tris, o, d)
        return t, tri, triangle_normals(tris, tri).unbind(1)
    t, nx, ny, nz, tri = trace_rays(qnodes, o, d, leaf_k=leaf_k, active=active,
                                    scattered=scattered, ordered=ordered)
    return t, tri, (nx, ny, nz)


def _occluded(qnodes, tris, o, d, brute: bool, leaf_k: int, active,
              scattered: bool = False, ordered: bool = True) -> torch.Tensor:
    """The NEE shadow query → the triangle plane of its any-hit wave: ≥ 0
    where the ray hits anything (:func:`~.ops.cuda.wave.blocked`)."""
    if brute:
        return trace_rays_brute(tris, o, d)[1]
    return trace_rays(qnodes, o, d, any_hit=True, leaf_k=leaf_k, active=active,
                      scattered=scattered, ordered=ordered)[4]


COMPACT_IMPLS = ("argsort", "partition")


_SPREAD = {}  # device → (the spread 10-bit values, the weights (4, 2, 1))


def _spread10(device) -> tuple[torch.Tensor, torch.Tensor]:
    """``ops.morton.expand_bits10`` of 0 … 1023 on ``device``, made there
    once (one gather a lane spreads its three quantised coordinates), and the
    weights (4, 2, 1) of the three axes' bits."""
    key = str(device)
    if key not in _SPREAD:
        _SPREAD[key] = (expand_bits10(torch.arange(1024, device=device)),
                        to_device((4, 2, 1), device, torch.int64))
    return _SPREAD[key]


def compaction_key(o: torch.Tensor, d: torch.Tensor, alive: torch.Tensor,
                   impl: str = "argsort") -> torch.Tensor:
    """The JAX package's compaction key of each lane (int64): dead lanes
    last, then the direction octant (x < 0 → 4, y < 0 → 2, z < 0 → 1), then
    the 30-bit Morton code m of the origin quantised as ``clip((o + 2) ·
    (1023 / 4), 0, 1023)`` (a multiply by that f32 constant, truncated).
    "argsort": the 32-bit key ``dead << 31 | octant << 28 | m >> 2``;
    "partition": the 8-bit key ``dead << 7 | octant << 4 | m >> 26`` over
    256 buckets. The three spread coordinates, and the three sign bits, sum
    without carries, so each field is one gather or compare and one sum."""
    dev = o.device
    q = torch.clamp((o + 2.0) * (1023.0 / 4.0), 0.0, 1023.0).to(torch.int64)
    spread, weights = _spread10(dev)
    m = (spread[q] * weights).sum(dim=1)
    octant = ((d < 0).to(torch.int64) * weights).sum(dim=1)
    dead = (~alive).to(torch.int64)
    if impl == "argsort":
        return (dead << 31) | (octant << 28) | (m >> 2)
    return (dead << 7) | (octant << 4) | (m >> 26)


def _compaction_perm(o: torch.Tensor, d: torch.Tensor, alive: torch.Tensor,
                     impl: str) -> torch.Tensor:
    """The stable permutation that sorts the lanes by :func:`compaction_key`.
    The 32-bit key is sorted as int32 after flipping its top bit, which keeps
    the unsigned order: torch sorts no uint32, and an int64 key would double
    the radix passes. A stable sort gives the JAX package's ``argsort``
    permutation."""
    key = compaction_key(o, d, alive, impl)
    if impl == "argsort":
        return torch.argsort((key - (1 << 31)).to(torch.int32), stable=True)
    return bucket_partition_perm(key, 256)


def pt_sample_frame(qnodes: torch.Tensor | None, tris: torch.Tensor, cam_pos, cam_quat,
                    width: int, height: int, *, bounces: int = 3,
                    fov_degrees: float = 70.0, leaf_k: int = 1, brute: bool = False,
                    tile_primary: bool = False, generator: torch.Generator | None = None,
                    uniforms: Mapping | None = None, stats: bool = False,
                    compact: bool = False, compact_impl: str = "argsort",
                    ordered_ch: bool = True, ordered_ah: bool = True):
    """One progressive sample: jittered camera rays plus ``bounces`` path-
    traced waves, each with its NEE shadow wave → linear radiance (H, W, 3)
    f32 on the device of ``tris``; with ``stats``, also {"alive_rays",
    "lane_rays"}: lanes whose result is used (live paths, plus shadow rays
    of lanes that hit and face the sun) and lanes traced (2·H·W per bounce).

    ``qnodes`` are the supernode records (``leaf_k`` triangles per leaf) of
    ``tris``; ``brute=True`` traces every wave by brute force instead and
    needs no records. ``tile_primary`` traces the camera wave through the
    jittered tile kernel (rays at the ``subpixel_hash01`` offsets of a
    22-bit seed ``pseed``); otherwise the camera rays sit at uniform
    offsets ``jx``, ``jy`` (H, W).

    Random numbers: ``generator`` (a ``torch.Generator`` on the device)
    draws ``jx``/``jy``, then per bounce b the cosine-sample uniforms
    ``u1[b]``, ``u2[b]`` (H·W,) in lane order; ``pseed`` comes from a host
    generator seeded with ``generator.initial_seed()``, so seed the
    generator anew for each sample, as ``render_progressive`` does.
    ``uniforms`` may inject any of them under those keys (``u1``/``u2`` as
    sequences over the bounces): the JAX package's draws make the two
    sample streams the same.

    With ``tile_primary`` the camera and ``pseed`` go to the device as the
    sample's camera row (:func:`camera_block`): K1b (``trace_tiles_row``)
    and ``camera_lanes`` read them there, and the camera rays start at a
    view of it. A CUDA graph that holds the sample (:class:`SampleGraph`)
    thus serves every camera and seed.

    ``compact=True`` compacts the lanes after every wave but the last (the
    JAX package's ``compact``; module docstring): by a stable argsort of the
    32-bit key (``compact_impl="argsort"``) or a stable partition by the
    8-bit key (``"partition"``, :mod:`~raytracer_tpu_torch.ops.partition`;
    the JAX package's ``RT_COMPACT``). The draws ``u1[b]``/``u2[b]`` then
    belong to the lanes in their compacted order, as in the JAX package.
    ``ordered_ch`` / ``ordered_ah`` (the JAX package's
    ``RT_WAVE_ORDERED_CH`` / ``_AH``) keep the near-first traversal order of
    the bounce waves after the camera wave and of every shadow wave; False
    traces them with ``trace_rays(ordered=False)``. Nothing here waits on the
    device, and only ``stats`` counts lanes.

    Spans (:mod:`raytracer_tpu_torch.utils.profiling`): each wave is one,
    ``rt/pt/camera`` (the camera rays made and traced) then ``rt/pt/bounce``,
    each with its NEE part nested as ``rt/pt/shadow``. Counters, summed over
    the waves on the device: ``rt/pt/shadow/cast``, the lanes that hit and
    face the sun, so cast a shadow ray; ``rt/pt/shadow/blocked``, those of
    them whose shadow ray hits something."""
    if compact_impl not in COMPACT_IMPLS:
        raise ValueError(f"compact_impl must be one of {COMPACT_IMPLS}, got {compact_impl!r}")
    if qnodes is None and not brute:
        raise ValueError("pt_sample_frame needs the records (qnodes) or brute=True")
    dev = tris.device
    draws = _Draws(uniforms, generator, dev)
    block = None
    if tile_primary and not brute and bounces > 0:
        block = camera_block(camera_row(cam_pos, cam_quat, width, height, fov_degrees,
                                        draws.pseed()), dev)
    return _sample(qnodes, tris, cam_pos, cam_quat, width, height, draws, block,
                   bounces=bounces, fov_degrees=fov_degrees, leaf_k=leaf_k, brute=brute,
                   stats=stats, compact=compact, compact_impl=compact_impl,
                   ordered_ch=ordered_ch, ordered_ah=ordered_ah)


def _sample(qnodes, tris, cam_pos, cam_quat, width: int, height: int, draws, block, *,
            bounces: int, fov_degrees: float, leaf_k: int, brute: bool = False,
            stats: bool = False, compact: bool = False, compact_impl: str = "argsort",
            ordered_ch: bool = True, ordered_ah: bool = True):
    """:func:`pt_sample_frame`'s waves with the random numbers ``draws``: the
    camera wave through K1b from ``block``, the sample's camera row on the
    device of ``tris``, or, where it is None, from ``cam_pos`` and
    ``cam_quat`` at the drawn offsets."""
    dev = tris.device
    f32 = torch.float32
    r = width * height

    radiance = torch.zeros((r, 3), dtype=f32, device=dev)
    throughput = torch.ones((r, 3), dtype=f32, device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    alive_rays = torch.zeros((), dtype=torch.int64, device=dev) if stats else None
    # the pixel (row-major index) of each lane, permuted with the lanes
    pix = img_to_lanes(torch.arange(r, device=dev).reshape(height, width), width,
                        height) if compact else None

    for b in range(bounces):
        with span("rt/pt/camera" if b == 0 else "rt/pt/bounce"):
            if stats:
                alive_rays = alive_rays + alive.sum()
            if b == 0 and block is not None:
                planes = trace_tiles_row(qnodes, block, width, height, fov_degrees,
                                         leaf_k=leaf_k)
                d, t, tri, n = camera_lanes(planes, block, width, height, fov_degrees)
                n = n.unbind(1)
                # every camera ray starts at the camera: a broadcast view of
                # the row's origin
                o = block[:3].reshape(1, 3).expand(r, 3)
            else:
                if b == 0:
                    o, d = _camera_rays(draws, cam_pos, cam_quat, width, height, fov_degrees,
                                        dev)
                # the lanes alive at b >= 2 are hits of random bounce rays;
                # compacted, they lead the buffer in a run
                t, tri, n = _trace(qnodes, tris, o.contiguous(), d.contiguous(), brute, leaf_k,
                                   None if b == 0 else alive, scattered=b >= 2 and not compact,
                                   ordered=ordered_ch or b == 0)
            # a miss sees the background on the camera wave, the sky after it
            n, hit, radiance, p, ndotl, nee = wave_hit(
                t, tri, n, o, d, alive, throughput, radiance, sun=_SUN,
                env=MISS_COLOR if b == 0 else _SKY, eps=_EPS_OFFSET)

            with span("rt/pt/shadow"):
                # NEE: lanes that hit and face the sun cast a shadow ray
                if stats:
                    alive_rays = alive_rays + nee.sum()
                occ = _occluded(qnodes, tris, p, _sun_dirs(dev, r), brute, leaf_k, nee,
                                scattered=b >= 1 and not compact, ordered=ordered_ah)
                if counting():
                    count("rt/pt/shadow/cast", nee.sum())
                    count("rt/pt/shadow/blocked", (blocked(occ) & nee).sum())

            # the direct light, then a cosine sample (the albedo absorbs the
            # brdf/pdf); the last wave instead adds the sky of the paths still
            # alive and returns the image (the lanes where compacted). Its
            # draws are made too, so the generator's stream stays the same.
            u1, u2 = draws.bounce(b, r)
            if b == bounces - 1:
                radiance = wave_last(occ, hit, ndotl, throughput, radiance, base=_BASE,
                                     sky=_SKY, size=None if compact else (width, height))
            else:
                o, d, throughput, alive, radiance = wave_bounce(
                    occ, hit, ndotl, throughput, radiance, n, p, o, d, u1, u2, base=_BASE)
                if compact:
                    perm = _compaction_perm(o, d, alive, compact_impl)
                    o, d, radiance, throughput = (o[perm], d[perm], radiance[perm],
                                                  throughput[perm])
                    alive, pix = alive[perm], pix[perm]

    if bounces == 0:  # no wave: every lane sees the sky
        radiance = radiance + torch.where(alive[:, None], throughput * _SKY, 0.0)
        if not compact:
            radiance = lanes_to_img(radiance, width, height)
    img = radiance
    if compact:
        img = torch.empty_like(radiance).index_copy_(0, pix, radiance).reshape(height, width, 3)
    if stats:
        return img, {"alive_rays": alive_rays,
                     "lane_rays": torch.full((), 2 * r * bounces, device=dev)}
    return img


def _camera_rays(draws, cam_pos, cam_quat, width: int, height: int, fov_degrees: float,
                 dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The camera wave's rays in lane order at the drawn offsets ``jx``,
    ``jy`` → (o, a broadcast view of the camera's position; d)."""
    jx, jy = draws.jitter(height, width)
    py, px = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    d = primary_dirs(px.reshape(-1), py.reshape(-1), width, height, cam_quat, fov_degrees,
                     jx.reshape(-1), jy.reshape(-1)).reshape(height, width, 3)
    o = to_device(cam_pos, dev).reshape(1, 3).expand(width * height, 3)
    return o, img_to_lanes(d, width, height)


def accumulate(accum: torch.Tensor, sample: torch.Tensor, frame_count,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Running mean: ``frame_count`` samples already in ``accum``, add one
    more: (accum·n + sample) / (n + 1) in f32. ``frame_count`` is an int, or
    a 0-d f32 tensor on ``accum``'s device that holds it (a uniform block's
    :data:`COUNT_COLUMN`, read when the op runs). ``out`` (``accum`` itself
    may be given) receives the mean in place of a new tensor.

    The multiply-add is rounded once (the f32 product is exact in f64), as
    the fused multiply-add that XLA makes of the JAX package's expression;
    two roundings would drift up to 2 ulps from it. The division is by a
    tensor: CUDA torch would run a division by a Python scalar as a multiply
    by its reciprocal."""
    n = (frame_count if isinstance(frame_count, torch.Tensor)
         else torch.full((), float(frame_count), dtype=torch.float32, device=accum.device))
    fused = (accum.double() * n.double() + sample.double()).float()
    return torch.div(fused, n + 1.0, out=out)


# The uniform block of a sample: the camera row that the camera wave is
# traced from (traverse.camera_row: the camera, its frame and the jitter
# seed), with the running mean's sample count in the row's first spare
# column.
COUNT_COLUMN = 14
_GRAPHS_KEPT = 4  # captured samples a tracer keeps, each with its memory pool
_STAGES = 8       # pinned host rows the blocks are copied from, used in turn


class _Staging:
    """A ring of ``_STAGES`` pinned host rows of CAMERA_ROW f32 that blocks
    on one device are copied from, without a stream synchronisation; a row
    is written again only once the copy it last served has ended."""

    def __init__(self) -> None:
        rows = [torch.empty((CAMERA_ROW,), dtype=torch.float32, pin_memory=True)
                for _ in range(_STAGES)]
        self._rows = [(row, row.numpy(), torch.cuda.Event()) for row in rows]
        self._next = 0

    def load(self, block: torch.Tensor, values: list[float]) -> None:
        """Copy ``values`` into ``block`` (on the card) from the next row."""
        row, host, copied = self._rows[self._next]
        self._next = (self._next + 1) % _STAGES
        if not copied.query():
            copied.synchronize()
        host[:] = values
        block.copy_(row, non_blocking=True)
        copied.record(torch.cuda.current_stream(block.device))


_STAGING: dict[str, _Staging] = {}  # device → its ring


def _load(block: torch.Tensor, values: list[float]) -> None:
    """Copy ``values`` into ``block`` on a CUDA device from pinned memory."""
    key = str(block.device)
    if key not in _STAGING:
        _STAGING[key] = _Staging()
    _STAGING[key].load(block, values)


def camera_block(values: list[float], device) -> torch.Tensor:
    """A sample's camera row ``values`` (``traverse.camera_row``, or a
    :func:`uniform_block`) as a (CAMERA_ROW,) f32 tensor on ``device``: on a
    card copied from pinned memory without a stream synchronisation."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.tensor(values, dtype=torch.float32, device=device)
    block = torch.empty((CAMERA_ROW,), dtype=torch.float32, device=device)
    _load(block, values)
    return block


def uniform_block(cam_pos, cam_quat, width: int, height: int, fov_degrees: float, pseed: int,
                  frame_count: int) -> list[float]:
    """The uniform block (CAMERA_ROW values) of a sample of the ``width`` ×
    ``height`` frame of ``fov_degrees`` from camera (``cam_pos``,
    ``cam_quat``) with jitter seed ``pseed``, added to a mean of
    ``frame_count`` samples: its camera row, and ``frame_count`` in
    :data:`COUNT_COLUMN`."""
    values = camera_row(cam_pos, cam_quat, width, height, fov_degrees, pseed)
    values[COUNT_COLUMN] = float(frame_count)
    return values


def sample_graph_eligible(device, *, tile_primary: bool, compact: bool, counting: bool,
                          uniforms: Mapping | None = None) -> bool:
    """Whether a progressive sample runs as a CUDA graph (:class:`SampleGraphs`):
    on a CUDA device, with the camera wave through K1b (``tile_primary``:
    records, not brute force), no injected ``uniforms``, no compaction and
    counters off. Every other sample runs its ops one by one, so that
    counters count what they count (a graph's replay computes no count) and
    the paths the graph leaves out stay as they are."""
    return (torch.device(device).type == "cuda" and tile_primary and not compact
            and not counting and uniforms is None)


class SampleGraph:
    """One progressive sample and its ``accumulate`` on the card:
    :func:`pt_sample_frame` of (``qnodes``, ``tris``, ``width`` × ``height``,
    ``bounces``, ``fov_degrees``, ``leaf_k``) fed from ``block`` with draws
    from ``generator``, and the mean ``mean`` updated in place, the count
    read from the block. :meth:`run` runs it: its ops one by one until
    :meth:`capture` has made it one CUDA graph, then a replay. Before each
    run the caller loads the block, sets ``mean`` and seeds the generator
    (:meth:`SampleGraphs.sample`)."""

    def __init__(self, qnodes: torch.Tensor, tris: torch.Tensor, width: int, height: int, *,
                 bounces: int, fov_degrees: float, leaf_k: int) -> None:
        dev = tris.device
        self._args = (qnodes, tris, width, height, bounces, fov_degrees, leaf_k)
        self.block = torch.zeros((CAMERA_ROW,), dtype=torch.float32, device=dev)
        self.mean = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        self.generator = torch.Generator(device=dev)
        self.last: torch.Tensor | None = None  # the copy of mean the last run returned
        self._graph: torch.cuda.CUDAGraph | None = None
        self._launches: dict[str, int] = {}  # each kernel's launches in one sample
        self._sun: torch.Tensor | None = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def _body(self) -> None:
        qnodes, tris, width, height, bounces, fov_degrees, leaf_k = self._args
        draws = _Draws(None, self.generator, tris.device)
        sample = _sample(qnodes, tris, None, None, width, height, draws, self.block,
                         bounces=bounces, fov_degrees=fov_degrees, leaf_k=leaf_k)
        accumulate(self.mean, sample, self.block[COUNT_COLUMN], out=self.mean)

    def capture(self) -> None:
        """Capture the sample as a CUDA graph (nothing runs), after it has run
        once op by op: the kernels' libraries are loaded and their first
        launches made. The generator is registered with the graph, so that
        a replay draws the stream of its seed then. The launches the capture
        made are kept as the sample's and taken off the counts."""
        _, tris, width, height = self._args[:4]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        # the shadow rays' directions, looked up (made anew, by a copy from
        # the host, if another lane count replaced them) before the capture,
        # which may copy nothing from the host, and held, so that they
        # outlive every replay
        self._sun = _sun_dirs(tris.device, width * height)
        before = dict(LAUNCHES)
        # thread_local: CUDA calls that other threads make meanwhile do not
        # fail the capture
        stream = torch.cuda.Stream(device=tris.device)
        with tracing(spans=False, counters=False), torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            self._body()
        self._launches = {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}
        LAUNCHES.update(before)
        LAUNCHES["sample_graph_capture"] += 1
        self._graph = graph

    def run(self) -> None:
        """The sample: a replay once captured, its ops one by one before."""
        if self._graph is None:
            self._body()
            return
        self._graph.replay()
        for name, n in self._launches.items():
            LAUNCHES[name] += n
        LAUNCHES["sample_graph_replay"] += 1


class SampleGraphs:
    """A tracer's progressive samples as CUDA graphs (:class:`SampleGraph`),
    one a key: the device, the frame, the bounces, the leaf size, the field
    of view and the identity of the records and the triangles. The first
    sample of a key runs op by op on the current stream, the warm-up; the
    next captures it and replays the graph, and every later one replays it.
    At most ``_GRAPHS_KEPT`` keys are kept, the one used least recently
    dropped first, and a key whose records or triangles are not the ones
    asked for now (a refit, a new scene) at once, so that device memory
    stays bounded.

    A sample costs the host one copy of its uniform block from pinned
    memory (a ring of ``_STAGES`` rows, none written again before its last
    copy has ended), one graph launch and one copy of the mean, which it
    returns: the graph's own buffers change at every replay, and a mean
    returned earlier must not."""

    def __init__(self) -> None:
        self._graphs: OrderedDict = OrderedDict()

    def sample(self, qnodes: torch.Tensor, tris: torch.Tensor, cam_pos, cam_quat, width: int,
               height: int, *, bounces: int, fov_degrees: float, leaf_k: int, frame_count: int,
               accum: torch.Tensor | None) -> torch.Tensor:
        """Sample ``frame_count`` of ``bounces`` bounces, as
        ``pt_sample_frame`` draws it from a device generator seeded with
        ``frame_count``, added to the mean ``accum`` of ``frame_count``
        samples (None: a mean that starts anew) → the new mean, (H, W, 3) f32,
        a tensor of its own."""
        dev = tris.device
        scene = (id(qnodes), id(tris))
        key = (str(dev), int(width), int(height), int(bounces), int(leaf_k),
               float(fov_degrees), scene)
        for old in [k for k in self._graphs if k[-1] != scene]:
            del self._graphs[old]
        with torch.cuda.device(dev):
            graph = self._graphs.get(key)
            if graph is None:
                graph = SampleGraph(qnodes, tris, width, height, bounces=bounces,
                                    fov_degrees=fov_degrees, leaf_k=leaf_k)
                self._graphs[key] = graph
                if len(self._graphs) > _GRAPHS_KEPT:
                    self._graphs.popitem(last=False)
            else:
                self._graphs.move_to_end(key)
                if not graph.captured:
                    graph.capture()
            graph.generator.manual_seed(frame_count)
            pseed = jitter_seed(graph.generator.initial_seed())
            _load(graph.block, uniform_block(cam_pos, cam_quat, width, height, fov_degrees, pseed,
                                             frame_count))
            if accum is None:
                graph.mean.zero_()
            elif accum is not graph.last:
                graph.mean.copy_(accum)
            graph.run()
            graph.last = graph.mean.clone()
        return graph.last
