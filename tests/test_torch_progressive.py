"""The PyTorch port's progressive path tracing against the JAX package, and
the behaviour spec of ``tests/test_progressive.py`` on the port.

Tolerances:
* ``subpixel_hash01``: bit-equal. ``generate_rays_jittered``: within
  2·2^-23 per component (the JAX function normalizes with rsqrt, the port
  with 1/sqrt).
* ``pt_sample_frame`` with the JAX package's uniforms injected: radiance
  within atol 1e-5 on >= 99% of pixels of JAX's brute-force sample, and
  the ``stats`` counts exactly equal. What can move a pixel: a tie between
  two triangles, or a bounce ray shifted by an ulp of the normal (the
  port's normals come from the records, JAX's brute-force ones from the
  vertices). Measured at these sizes: 100% of pixels, max |Δ| 1.2e-7.
* ``accumulate``: within 1 ulp. ``present_progressive``: within 1 LSB.
* ``render_progressive(bounces=0)``: within atol 1e-5 on >= 99.9% of
  pixels of the JAX PathTracer's (only an edge ray moved by the rsqrt ulps
  can differ).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu
from raytracer_tpu.ops.camera import generate_rays_jittered as jax_generate_rays_jittered
from raytracer_tpu.ops.camera import subpixel_hash01 as jax_subpixel_hash01
from raytracer_tpu.render_pt import _img_to_lanes as jax_img_to_lanes
from raytracer_tpu.render_pt import accumulate as jax_accumulate
from raytracer_tpu.render_pt import pt_sample_frame as jax_pt_sample_frame
from raytracer_tpu.utils import procgen as jax_procgen
from raytracer_tpu_torch import PathTracer, Scene, accumulate, pt_sample_frame
from raytracer_tpu_torch.ops.camera import _mul32, generate_rays_jittered, subpixel_hash01
from raytracer_tpu_torch.ops.lanes import img_to_lanes, lanes_to_img
from raytracer_tpu_torch.ops.shade import MISS_COLOR
from test_torch_trace import jax_records
from torch_parity import seeded_scene

ROOM_POS, ROOM_QUAT = (0.0, 0.1, 2.2), (0.0, 0.05, 0.0, 0.99874922)
CAM_QUAT = (0.0, 0.0, 0.0, 1.0)


def jax_uniforms(key, width: int, height: int, bounces: int) -> dict:
    """The draws of the JAX package's non-tile pt_sample_frame for ``key``
    (render_pt.py:295,314-315,400-401), as writable numpy arrays."""
    keys = jax.random.split(key, 2 + 2 * bounces)
    r = width * height

    def u(k, shape):
        return np.array(jax.random.uniform(k, shape))

    return {"jx": u(keys[0], (height, width)), "jy": u(keys[1], (height, width)),
            "u1": [u(keys[2 + 2 * b], (r,)) for b in range(bounces)],
            "u2": [u(keys[3 + 2 * b], (r,)) for b in range(bounces)]}


def test_subpixel_hash_bit_equal_to_jax():
    px, py = np.meshgrid(np.arange(0, 1920, 7, dtype=np.int32),
                         np.arange(0, 1080, 5, dtype=np.int32))
    for seed in (0, 1, 2, 777, (1 << 22) - 1, 2 * ((1 << 22) - 1) + 1, (1 << 31) - 1, -3):
        ref = np.asarray(jax_subpixel_hash01(jnp.asarray(px), jnp.asarray(py), jnp.int32(seed)))
        ours = subpixel_hash01(torch.from_numpy(px), torch.from_numpy(py), seed).numpy()
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32), err_msg=seed)


def test_mul32_keeps_the_low_32_bits_near_2_32():
    """The hash's multiplies by 0x7FEB352D and 0x846CA68B at h near 2^32,
    where the full product overflows int64, against Python's integers."""
    h = np.array([2**32 - 1, 2**32 - 2, 2**32 - 12345, 2**31, 2**31 - 1, 0, 1], np.int64)
    for c in (0x7FEB352D, 0x846CA68B, 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D):
        got = _mul32(torch.from_numpy(h), c).tolist()
        assert got == [(int(x) * c) % 2**32 for x in h], hex(c)


def test_generate_rays_jittered_matches_jax():
    w, h, seed = 48, 40, 123457
    pos, quat = (0.1, 0.2, 3.0), (0.05, -0.1, 0.0, 0.9937303)
    o_ref, d_ref = jax_generate_rays_jittered(w, h, jnp.asarray(pos, jnp.float32),
                                              jnp.asarray(quat, jnp.float32), seed)
    o, d = generate_rays_jittered(w, h, pos, quat, seed, device="cpu")
    assert d.shape == (h, w, 3) and o.shape == (h, w, 3)
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    err = np.abs(d.numpy() - np.asarray(d_ref)).max()
    assert err <= 2 * np.spacing(np.float32(1.0)), f"max |Δ| {err} > 2·2^-23"


@pytest.mark.parametrize("width,height", [(64, 32), (40, 24)], ids=["aligned", "ragged"])
def test_lane_order_matches_jax(width, height):
    """Tile-block lane order: the reshape branch (multiples of 32) and the
    gather/scatter branch, against the JAX package's, and the round trip."""
    img = np.random.default_rng(0).random((height, width, 3)).astype(np.float32)
    lanes = img_to_lanes(torch.from_numpy(img), width, height)
    np.testing.assert_array_equal(lanes.numpy(),
                                  np.asarray(jax_img_to_lanes(jnp.asarray(img), width, height)))
    assert torch.equal(lanes_to_img(lanes, width, height), torch.from_numpy(img))


@pytest.mark.parametrize("width,height,bounces",
                         [(32, 32, 1), (32, 32, 3), (40, 24, 1), (40, 24, 3)])
def test_sample_matches_jax_brute_with_injected_uniforms(width, height, bounces):
    """The port's pt_sample_frame (records of the JAX package, plain
    versions, camera wave at uniform offsets) with the uniforms of
    jax.random.split(key, 2 + 2·bounces) vs JAX's pt_sample_frame(brute=True)
    with the same key, inside the Cornell box."""
    tris = jax_procgen.make_cornell_box()
    qn = jax_records(tris, 8)
    key = jax.random.key(5)
    ref, ref_stats = jax_pt_sample_frame(
        None, jnp.asarray(tris), jnp.asarray(ROOM_POS, jnp.float32),
        jnp.asarray(ROOM_QUAT, jnp.float32), key, width, height, bounces=bounces,
        brute=True, stats=True)
    ours, stats = pt_sample_frame(
        torch.from_numpy(qn), torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, width, height,
        bounces=bounces, leaf_k=8, uniforms=jax_uniforms(key, width, height, bounces),
        stats=True)
    assert ours.shape == (height, width, 3) and ours.dtype == torch.float32
    err = np.abs(ours.numpy() - np.asarray(ref)).max(-1)
    share = float((err <= 1e-5).mean())
    assert share >= 0.99, f"{share:.4f} of pixels within 1e-5 (max |Δ| {err.max()})"
    assert int(stats["alive_rays"]) == int(ref_stats["alive_rays"])
    assert int(stats["lane_rays"]) == int(ref_stats["lane_rays"]) == 2 * width * height * bounces


def test_tile_primary_sample_matches_uniform_camera_wave():
    """The jittered tile-kernel camera wave (plain K1b on the CPU) gives the
    sample that the ray-buffer camera wave gives at the same subpixel
    offsets, injected as jx/jy (the two normalize a direction differently,
    so an edge ray may move)."""
    tris = jax_procgen.make_cornell_box()
    qn = torch.from_numpy(jax_records(tris, 8))
    w, h, b, pseed = 40, 24, 2, 987654
    rng = np.random.default_rng(2)
    u = {"u1": [rng.random(w * h).astype(np.float32) for _ in range(b)],
         "u2": [rng.random(w * h).astype(np.float32) for _ in range(b)]}
    tiled = pt_sample_frame(qn, torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, w, h, bounces=b,
                            leaf_k=8, tile_primary=True, uniforms={"pseed": pseed, **u})
    py, px = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    jx, jy = subpixel_hash01(px, py, 2 * pseed), subpixel_hash01(px, py, 2 * pseed + 1)
    flat = pt_sample_frame(qn, torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, w, h, bounces=b,
                           leaf_k=8, uniforms={"jx": jx, "jy": jy, **u})
    err = (tiled - flat).abs().amax(-1)
    assert float((err <= 1e-5).float().mean()) >= 0.99


def test_tile_primary_seed_is_drawn_on_the_host():
    """Without injected uniforms the camera wave's jitter seed comes from a
    host generator seeded with the generator's initial seed: the same seed
    gives the same sample, another seed another one, and the generator's
    own stream (the device draws u1/u2) is not advanced by it."""
    tris = jax_procgen.make_cornell_box()
    qn = torch.from_numpy(jax_records(tris, 8))

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        out = pt_sample_frame(qn, torch.from_numpy(tris), ROOM_POS, ROOM_QUAT, 16, 8,
                              bounces=1, leaf_k=8, tile_primary=True, generator=gen)
        return out, gen

    a, gen = sample(3)
    b, _ = sample(3)
    c, _ = sample(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    after = torch.Generator().manual_seed(3)
    torch.rand((16 * 8,), generator=after)
    torch.rand((16 * 8,), generator=after)
    assert torch.equal(gen.get_state(), after.get_state())


def test_accumulate_and_present_match_jax():
    rng = np.random.default_rng(4)
    acc = rng.random((24, 40, 3)).astype(np.float32) * 3
    sample = rng.random((24, 40, 3)).astype(np.float32) * 3
    for n in (0, 1, 6, 1000):
        ours = accumulate(torch.from_numpy(acc), torch.from_numpy(sample), n).numpy()
        ref = np.asarray(jax_accumulate(jnp.asarray(acc), jnp.asarray(sample), jnp.int32(n)))
        ulps = np.abs(ours.view(np.int32).astype(np.int64) - ref.view(np.int32))
        assert ulps.max() <= 1, (n, ulps.max())

    pt = PathTracer(40, 24, device="cpu")
    pt._accum = torch.from_numpy(acc)
    jpt = raytracer_tpu.PathTracer(40, 24)
    jpt._accum = jnp.asarray(acc)
    shown, ref = pt.present_progressive(), np.asarray(jpt.present_progressive())
    assert shown.shape == (24, 40, 4) and shown.dtype == torch.uint8
    assert np.abs(shown.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_render_progressive_aa_matches_jax_pathtracer():
    """bounces=0 on the CPU: the port (SAH, K = 32, plain K1b) against the
    JAX PathTracer (its default builder, XLA traversal) on one icosphere,
    three frames. Both jitter by subpixel_hash01 with seed frame_count + 1."""
    tris = seeded_scene(3)
    w, h = 48, 32
    pt = PathTracer(w, h, builder="sah", leaf_size=32, device="cpu")
    pt.set_scene(Scene().set_triangles(tris))
    jpt = raytracer_tpu.PathTracer(w, h)
    jpt.set_scene(raytracer_tpu.Scene().set_triangles(tris))
    for cam in (pt, jpt):
        cam.set_camera_position(0.15, -0.1, 2.5)
        cam.set_camera_quaternion(0.0, 0.1, 0.0, 0.9949874)
    for _ in range(3):
        ours = pt.render_progressive(bounces=0)
        ref = np.asarray(jpt.render_progressive(bounces=0))
    assert pt.frame_count == jpt.frame_count == 3
    err = np.abs(ours.numpy() - ref).max(-1)
    assert float((err <= 1e-5).mean()) >= 0.999, err.max()
    assert 0.2 < float((ours[..., 0] != MISS_COLOR).float().mean()) < 0.9


# -- the behaviour spec of tests/test_progressive.py, on the port -------------------


def cornell_tracer(w: int = 16, h: int = 16) -> PathTracer:
    pt = PathTracer(w, h, builder="sah", leaf_size=8, device="cpu")
    pt.set_scene(Scene().set_triangles(jax_procgen.make_cornell_box()))
    return pt


def test_progressive_reset_on_camera_move_and_frame_count():
    pt = cornell_tracer()
    pt.render_progressive(bounces=2)
    pt.render_progressive(bounces=2)
    assert pt.frame_count == 2
    pt.set_camera_position(0.1, 0.0, 3.5)
    acc = pt.render_progressive(bounces=2)
    assert pt.frame_count == 1
    assert acc.shape == (16, 16, 3) and bool(torch.isfinite(acc).all())
    pt.set_frame_count(7)
    assert pt.frame_count == 7
    img = pt.present_progressive()
    assert img.shape == (16, 16, 4) and img.dtype == torch.uint8
    a1 = pt.render_progressive(bounces=0).clone()
    a2 = pt.render_progressive(bounces=0)
    assert pt.frame_count == 9 and a1.shape == a2.shape == (16, 16, 3)
    assert bool((a2 >= 0).all())


def test_radiance_finite_nonnegative_and_background_miss_color():
    tris = jax_procgen.make_cornell_box()
    s = pt_sample_frame(None, torch.from_numpy(tris), (0.0, 1.0, 3.0), CAM_QUAT, 16, 16,
                        bounces=3, brute=True, generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(s).all() & (s >= 0).all())
    cube = torch.from_numpy(jax_procgen.make_cube(0.3))
    s = pt_sample_frame(None, cube, (0.0, 0.0, 5.0), CAM_QUAT, 16, 16, bounces=2, brute=True,
                        generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(s[0, 0].numpy(), [MISS_COLOR] * 3, atol=1e-6)


def test_direct_light_converges_on_open_plane():
    """Unoccluded plane: the mean converges to the Lambert shade
    ρ·(0.15 + n·l) (the sky supplies the 0.15; nothing to bounce off)."""
    pt = PathTracer(24, 24, device="cpu")
    pt.set_scene(Scene().set_triangles(jax_procgen.make_quad(50.0, y=0.0)))
    pt.set_camera_position(0.0, 1.0, 3.0)
    for _ in range(48):
        acc = pt.render_progressive(bounces=2)
    sun = np.array([1.0, 1.5, 1.0]) / np.linalg.norm([1.0, 1.5, 1.0])
    want = np.array([0.9, 0.7, 0.3]) * (0.15 + sun[1])
    np.testing.assert_allclose(acc[4, 12].numpy(), want, rtol=0.08)


def test_gi_adds_bounded_energy_in_cornell_box():
    pt = cornell_tracer(12, 12)
    pt.set_camera_position(0.0, 0.0, 2.2)

    def mean_radiance(bounces, n=8):
        pt.set_camera_position(0.0, 0.0, 2.2 + bounces * 1e-3)  # a fresh buffer
        for _ in range(n):
            acc = pt.render_progressive(bounces=bounces)
        return float(acc.mean())

    direct, gi = mean_radiance(1), mean_radiance(3)
    assert direct * 1.01 < gi < direct * 3.0


def test_sample_refuses_compaction_and_missing_inputs():
    tris = torch.from_numpy(jax_procgen.make_cube(0.3))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="compact_impl"):
        pt_sample_frame(None, tris, (0, 0, 3), CAM_QUAT, 8, 8, brute=True, generator=gen,
                        compact=True, compact_impl="bitonic")
    with pytest.raises(ValueError):
        pt_sample_frame(None, tris, (0, 0, 3), CAM_QUAT, 8, 8, generator=gen)
    with pytest.raises(ValueError):
        pt_sample_frame(None, tris, (0, 0, 3), CAM_QUAT, 8, 8, brute=True)
    with pytest.raises(RuntimeError):
        PathTracer(8, 8, device="cpu").present_progressive()
