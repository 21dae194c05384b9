"""The PyTorch port's refit chain against the JAX package: the fp16
packers, ``refit_lbvh2_clustered``, ``collapse_plan``,
``collapse_apply_refit`` and ``PathTracer.refit_bvh``.

Same inputs, made with numpy from a fixed seed, go through the JAX function
and its port. Every stage is integer or bit-level, so each comparison is
exact (bit-equal), except the rendered image: within 1 LSB of rgba8 per
channel, as in test_torch_pathtracer.py.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu import PathTracer as JaxPathTracer
from raytracer_tpu.ops import fp16_jax
from raytracer_tpu.ops.cluster import build_lbvh2_clustered as jax_build_lbvh2_clustered
from raytracer_tpu.ops.cluster import build_sah2_clustered as jax_build_sah2_clustered
from raytracer_tpu.ops.cluster import refit_lbvh2_clustered as jax_refit
from raytracer_tpu.ops.collapse import collapse_apply_refit as jax_apply_refit
from raytracer_tpu.ops.collapse import collapse_lbvh2_to_bvh4 as jax_collapse
from raytracer_tpu.ops.collapse import collapse_plan as jax_collapse_plan
from raytracer_tpu.ops.shade import quantize_rgba8 as jax_quantize_rgba8
from raytracer_tpu.render import render_ldr_brute
from raytracer_tpu_torch import PathTracer
from raytracer_tpu_torch.ops.cluster import (build_sah2_clustered, records_pipeline,
                                             refit_lbvh2_clustered, state_from_numpy,
                                             tree_height)
from raytracer_tpu_torch.ops.collapse import (collapse_apply_refit, collapse_lbvh2_to_bvh4,
                                              collapse_plan)
from raytracer_tpu_torch.ops.cuda.traverse import make_qnodes
from raytracer_tpu_torch.ops.trace import make_wide_bvh
from raytracer_tpu_torch.utils import fp16
from test_torch_records import checkpoint_arrays, seeded_mesh

PHASES = (0.0, 0.7, 2.1)


def deform(tris: np.ndarray, phase: float) -> np.ndarray:
    """The deformations of the JAX package's collapse-plan test: scale and
    shift."""
    return (tris * (1.0 + 0.1 * np.sin(phase)) + np.float32(phase)).astype(np.float32)


def u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def fp16_sweep() -> tuple[np.ndarray, np.ndarray]:
    """f32 values at, just beside and between every fp16 value (every
    boundary of the rounding, the subnormal range, ±0), past the largest
    finite fp16 (overflow) and ±inf; and a seeded permutation of them."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    v = bits.view(np.float16).astype(np.float32)
    vb = v[~np.isnan(v)].view(np.uint32).astype(np.int64)
    # ±1 f32 ulp, and either side of half an fp16 ulp (the rounding ties)
    near = np.concatenate([vb + d for d in (0, 1, -1, 0xFFF, 0x1000, 0x1001, -0xFFF, -0x1000,
                                            -0x1001)])
    near = near[(near >= 0) & (near < 1 << 32)].astype(np.uint32).view(np.float32)
    extra = np.float32([0.0, -0.0, np.inf, -np.inf, 65504, 65519.996, 65520, 1e6, -1e6,
                        2.0 ** -25, 2.0 ** -24, 3 * 2.0 ** -26, -(2.0 ** -25), 1e-8])
    x = np.concatenate([near, extra])
    x = x[~np.isnan(x)]
    return x, np.random.default_rng(3).permutation(x)


@pytest.mark.parametrize("name", ["pack16x2", "increment_f16_down", "increment_f16_up",
                                  "pack_bounds", "pack_bounds_conservative"])
def test_fp16_packers_bit_equal(name):
    """The torch packers against fp16_jax on a sweep of every fp16 boundary,
    ±0, subnormals, overflow and inf: bit-equal (as u32 words or f32 bits)."""
    x, y = fp16_sweep()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if name == "pack16x2":
        ours, ref = fp16.pack16x2(tx, ty).numpy(), u32(fp16_jax.pack16x2(x, y))
    elif name.startswith("increment_f16"):
        up = name.endswith("up")
        ours = fp16.increment_f16(tx, up).numpy().view(np.uint32)
        ref = np.asarray(fp16_jax.increment_f16(jnp.asarray(x), up)).view(np.uint32)
    else:
        n = x.size // 3 * 3
        mn, mx = x[:n].reshape(-1, 3), y[:n].reshape(-1, 3)
        ours = getattr(fp16, name)(torch.from_numpy(mn), torch.from_numpy(mx)).numpy()
        # jitted, as every JAX build calls it: XLA drops the fp16 round trip
        # between the step and the pack, which op by op quiets a NaN
        ref = u32(jax.jit(getattr(fp16_jax, name))(jnp.asarray(mn), jnp.asarray(mx)))
    assert ours.shape == ref.shape and np.array_equal(ours, ref.astype(ours.dtype)), \
        "tolerance: bit-equal"


@pytest.fixture(scope="module", params=[("sah", 2, 8), ("sah", 3, 32), ("morton", 3, 8)],
                ids=["sah-ico2-K8", "sah-ico3-K32", "morton-ico3-K8"])
def trees(request):
    """(kind, triangles, JAX ClusteredScene, JAX sweep cap, port state): a
    JAX-built SAH or Morton cluster tree, carried across with
    state_from_numpy."""
    kind, sub, k = request.param
    tris = seeded_mesh(sub)
    if kind == "sah":
        cs, height = jax_build_sah2_clustered(jnp.asarray(tris), k)
        sweeps = height + 2
    else:
        cs, sweeps = jax_build_lbvh2_clustered(jnp.asarray(tris), k), None
    return kind, tris, cs, sweeps, state_from_numpy(checkpoint_arrays(cs, tris), "cpu")


def test_refit_matches_jax(trees):
    """Bounds and tris_sorted bit-equal to the JAX refit after three
    deformations; the port's fixed sweep count (with the cap given, or the
    tree's height without it) gives the JAX convergence loop's result, and
    any count from the height up gives the same bits."""
    _, tris, cs, sweeps, state = trees
    height = tree_height(state.bvh2)
    for phase in PHASES:
        d = deform(tris, phase)
        ref = jax_refit(cs, jnp.asarray(d), num_sweeps=sweeps)
        ours = refit_lbvh2_clustered(state, torch.from_numpy(d), num_sweeps=sweeps)
        assert np.array_equal(ours.bvh2.bounds_u32.numpy(), u32(ref.bvh2.bounds_u32)), \
            "tolerance: bit-equal"
        assert np.array_equal(ours.tris_sorted.numpy(), np.asarray(ref.tris_sorted))
        assert torch.equal(ours.tri_order, state.tri_order) and ours.leaf_size == state.leaf_size
        for name in ("left", "right", "meta", "parent"):
            assert torch.equal(getattr(ours.bvh2, name), getattr(state.bvh2, name))
        for n in (None, height, height + 5):
            again = refit_lbvh2_clustered(state, torch.from_numpy(d), num_sweeps=n)
            assert torch.equal(again.bvh2.bounds_u32, ours.bvh2.bounds_u32)
    # below the height neither converges, and both stop at the same sweep
    d = deform(tris, PHASES[1])
    short = refit_lbvh2_clustered(state, torch.from_numpy(d), num_sweeps=height - 2)
    ref = jax_refit(cs, jnp.asarray(d), num_sweeps=height - 2)
    assert np.array_equal(short.bvh2.bounds_u32.numpy(), u32(ref.bvh2.bounds_u32))


def test_refit_sweeps_reach_the_fixed_point(trees):
    """One more sweep changes nothing after ``tree_height`` sweeps and
    something after one fewer: the height is where the loop converges."""
    _, tris, _, _, state = trees
    d = torch.from_numpy(deform(tris, PHASES[2]))
    h = tree_height(state.bvh2)
    b = [refit_lbvh2_clustered(state, d, num_sweeps=n).bvh2.bounds_u32 for n in (h - 1, h, h + 1)]
    assert not torch.equal(b[0], b[1]) and torch.equal(b[1], b[2])
    if trees[0] == "sah":
        assert h + 2 == trees[3]  # the native build reports the same height


def test_collapse_plan_matches_jax(trees):
    _, _, cs, sweeps, state = trees
    ref = jax_collapse_plan(cs.bvh2, sweeps=sweeps)
    ours = collapse_plan(state.bvh2, sweeps=sweeps)
    assert isinstance(ours.num_nodes, int) and ours.num_nodes == int(ref.num_nodes)
    for name in ("children", "meta", "src", "emitted"):
        assert np.array_equal(getattr(ours, name).numpy().astype(np.int64),
                              u32(getattr(ref, name))), f"{name}: tolerance: exact"


def test_apply_refit_matches_jax_and_the_full_collapse(trees):
    """collapse_apply_refit of the refitted bounds equals JAX's, JAX's full
    device collapse and (on SAH trees) the port's native full collapse of
    the refitted tree; the records built from it equal the records
    pipeline's."""
    kind, tris, cs, sweeps, state = trees
    plan = collapse_plan(state.bvh2, sweeps=sweeps)
    ref_plan = jax_collapse_plan(cs.bvh2, sweeps=sweeps)
    for phase in PHASES[1:]:
        d = deform(tris, phase)
        cs_r = refit_lbvh2_clustered(state, torch.from_numpy(d), num_sweeps=sweeps)
        ref_r = jax_refit(cs, jnp.asarray(d), num_sweeps=sweeps)
        ours = collapse_apply_refit(plan, cs_r.bvh2.bounds_u32)
        refs = [jax_apply_refit(ref_plan, ref_r.bvh2.bounds_u32),
                jax_collapse(ref_r.bvh2, sweeps=sweeps)]
        for ref in refs:
            assert ours.num_nodes == int(ref.num_nodes)
            for name in ("bounds_u32", "children", "meta"):
                assert np.array_equal(getattr(ours, name).numpy(), u32(getattr(ref, name))), \
                    f"{name}: tolerance: bit-equal"
        if kind == "sah":
            full = collapse_lbvh2_to_bvh4(cs_r.bvh2)
            assert full.num_nodes == ours.num_nodes
            for name in ("bounds_u32", "children", "meta"):
                assert torch.equal(getattr(full, name), getattr(ours, name)), name
            qn = make_qnodes(make_wide_bvh(ours), cs_r.tris_sorted, tri_ids=cs_r.tri_order,
                             leaf_size=cs_r.leaf_size)
            assert torch.equal(qn.view(torch.int32), records_pipeline(cs_r).view(torch.int32))


def flat_ground_scene() -> np.ndarray:
    """Triangles all flat at y = 0 (internal rows carry fp16-subnormal max-y
    halfwords), plus sub-2^-14 x extents on a tail cluster."""
    rng = np.random.default_rng(5)
    c = rng.uniform(-1, 1, size=(129, 1, 3))
    tris = (c + rng.normal(scale=0.05, size=(129, 3, 3))).astype(np.float32)
    tris[:, :, 1] = 0.0
    tris[-8:, :, 0] *= np.float32(1e-6)
    return tris.astype(np.float32)


@pytest.mark.parametrize("kind", ["sah", "morton"])
def test_apply_refit_flat_ground_plane(kind):
    """The flat y = 0 scene, where the subnormal flush matters: the port's
    plan path equals JAX's plan path and full collapse, and (SAH) the native
    full collapse; and the flush fires."""
    tris = flat_ground_scene()
    if kind == "sah":
        cs, height = jax_build_sah2_clustered(jnp.asarray(tris), 8)
        sweeps = height + 2
    else:
        cs, sweeps = jax_build_lbvh2_clustered(jnp.asarray(tris), 8), None
    state = state_from_numpy(checkpoint_arrays(cs, tris), "cpu")
    plan = collapse_plan(state.bvh2, sweeps=sweeps)
    cs_r = refit_lbvh2_clustered(state, torch.from_numpy(tris), num_sweeps=sweeps)
    ours = collapse_apply_refit(plan, cs_r.bvh2.bounds_u32)
    ref_r = jax_refit(cs, jnp.asarray(tris), num_sweeps=sweeps)
    assert np.array_equal(cs_r.bvh2.bounds_u32.numpy(), u32(ref_r.bvh2.bounds_u32))
    for ref in (jax_apply_refit(jax_collapse_plan(cs.bvh2, sweeps=sweeps), ref_r.bvh2.bounds_u32),
                jax_collapse(ref_r.bvh2, sweeps=sweeps)):
        assert np.array_equal(ours.bounds_u32.numpy(), u32(ref.bounds_u32)), "tolerance: bit-equal"
        assert np.array_equal(ours.children.numpy(), u32(ref.children))
    if kind == "sah":
        assert torch.equal(collapse_lbvh2_to_bvh4(cs_r.bvh2).bounds_u32, ours.bounds_u32)
    raw = torch.where(plan.emitted[:, None], cs_r.bvh2.bounds_u32[plan.src], 0)
    assert bool((raw != ours.bounds_u32).any()), "the flush of subnormal halfwords fired"


def test_refit_bvh_matches_jax_pathtracer():
    """PathTracer.refit_bvh on the CPU against the JAX package's
    PathTracer(builder="sah", leaf_size=8).refit_bvh: records byte-equal
    after each of two deformations, and render() within 1 LSB of the JAX
    brute-force pipeline on the deformed mesh."""
    w, h = 96, 64
    pos, quat = (0.2, 0.1, 2.6), (0.05, -0.1, 0.0, 0.9937303)
    tris = seeded_mesh(3)
    jpt = JaxPathTracer(w, h, builder="sah", leaf_size=8)
    jpt.build_bvh(tris)
    pt = PathTracer(w, h, builder="sah", leaf_size=8, device="cpu")
    pt.build_bvh(tris)
    pt.set_camera_position(*pos)
    pt.set_camera_quaternion(*quat)
    for phase in PHASES[1:]:
        d = deform(tris, phase) - np.float32(phase)
        jpt.refit_bvh(d)
        pt.refit_bvh(d)
        ref = np.asarray(jpt._qnodes)
        assert np.array_equal(pt._qnodes.numpy().view(np.uint32),
                              ref.reshape(ref.shape[0], -1).view(np.uint32)), "tolerance: byte-equal"
        assert np.array_equal(pt._tris_dev.numpy(), d) and pt.triangles_data is not tris
        assert "plan_ms" in pt.build_stats and pt._collapse_plan is not None
    img = pt.render()
    rgb, _, tri = render_ldr_brute(jnp.asarray(d), jnp.asarray(pos, jnp.float32),
                                   jnp.asarray(quat, jnp.float32), w, h, pt.fov_degrees)
    assert 0.1 < float((np.asarray(tri) >= 0).mean()) < 0.9
    ref_img = np.asarray(jax_quantize_rgba8(rgb)).astype(np.int32)
    assert np.abs(img.numpy().astype(np.int32) - ref_img).max() <= 1, "tolerance: 1 LSB"


def test_refit_bvh_rebuilds_when_the_tree_cannot_be_kept():
    """Another triangle count rebuilds (as build_bvh would, with a new plan);
    so does a scene traced brute force (no cluster tree)."""
    tris = seeded_mesh(2)
    pt = PathTracer(48, 32, builder="sah", leaf_size=8, device="cpu")
    pt.build_bvh(tris)
    pt.refit_bvh(deform(tris, 0.7))
    assert pt._collapse_plan is not None
    fewer = tris[:-8]
    pt.refit_bvh(fewer)
    assert pt._collapse_plan is None and "plan_ms" not in pt.build_stats
    fresh = PathTracer(48, 32, builder="sah", leaf_size=8, device="cpu")
    fresh.build_bvh(fewer)
    assert torch.equal(pt._qnodes.view(torch.int32), fresh._qnodes.view(torch.int32))

    pt.initialize()
    pt.build_bvh(tris[:4])
    pt.refit_bvh(tris[:4] * np.float32(1.5))
    assert pt._qnodes is None and pt._cluster is None
    assert np.array_equal(pt._tris_dev.numpy(), tris[:4] * np.float32(1.5))


def test_refit_bvh_after_load_checkpoint(tmp_path):
    """A tree loaded from a JAX checkpoint refits (the checkpoint holds no
    height: the port reads it from the tree) to the JAX refit's records."""
    tris = seeded_mesh(3)
    jpt = JaxPathTracer(64, 32, builder="sah", leaf_size=8)
    jpt.build_bvh(tris)
    ckpt = tmp_path / "scene.npz"
    jpt.save_checkpoint(ckpt)
    pt = PathTracer(64, 32, builder="sah", leaf_size=32, device="cpu")
    pt.load_checkpoint(ckpt)
    assert pt._bvh2_height == jpt._bvh2_height
    d = deform(tris, 2.1)
    jpt.refit_bvh(d)
    pt.refit_bvh(d)
    ref = np.asarray(jpt._qnodes)
    assert np.array_equal(pt._qnodes.numpy().view(np.uint32),
                          ref.reshape(ref.shape[0], -1).view(np.uint32)), "tolerance: byte-equal"


def test_refit_keeps_the_port_build_exact():
    """A refit to the build's own triangles reproduces the build's records
    (the build packs internal boxes conservatively per level, so its boxes
    may be larger; the refit's equal the native full collapse of its own
    bounds), and tree_height is the native builder's height."""
    tris = seeded_mesh(3)
    state, height = build_sah2_clustered(tris, 8, "cpu")
    assert tree_height(state.bvh2) == height
    cs_r = refit_lbvh2_clustered(state, torch.from_numpy(tris), num_sweeps=height + 2)
    bvh4 = collapse_apply_refit(collapse_plan(state.bvh2, height + 2), cs_r.bvh2.bounds_u32)
    qn = make_qnodes(make_wide_bvh(bvh4), cs_r.tris_sorted, tri_ids=cs_r.tri_order, leaf_size=8)
    assert torch.equal(qn.view(torch.int32), records_pipeline(cs_r).view(torch.int32))
    mn, mx = fp16.unpack_bounds(cs_r.bvh2.bounds_u32)
    bmn, bmx = fp16.unpack_bounds(state.bvh2.bounds_u32)
    assert bool((mn >= bmn).all() & (mx <= bmx).all())
