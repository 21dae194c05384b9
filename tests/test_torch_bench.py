"""The port's benchmark entry points (``bench_torch.py``,
``bench_suite_torch.py``, ``tools_torch/make_suite_snapshot.py``) at toy
size on the CPU, against the JAX package and the JAX scripts.

Tolerances:
* Config 1's hit counts a frame: within 1e-4 of the rays of the JAX suite's
  CPU path (``render_ldr``), the limit of PERF.md §2 — the two packages
  normalize a ray's direction differently (rsqrt against 1/sqrt), which can
  move a ray that grazes a seam of the box; and equal to the port's
  ``render_ldr_brute``.
* Config 5's records a frame: bit-equal to the JAX chain (refit → apply
  the collapse plan → wide → records) of the same deformed triangles; the
  hit counts of its 8 cameras within 1e-4 of the rays of JAX
  ``render_ldr_brute``'s on the deformed triangles.
* Configs 2 and 4's sample, with the JAX package's uniforms injected and
  the camera wave at uniform offsets: radiance within atol 1e-5 on >= 99% of
  pixels of JAX's ``pt_sample_frame`` (brute force), and the ``stats``
  counts exactly equal — the progressive contract of
  ``test_torch_progressive.py``.
* The JSON lines: the keys and metric names of the JAX scripts, exactly.

No Pallas kernel runs here: the JAX side is its XLA traversal and brute
force.
"""

import ast
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_suite_torch as suite
import bench_torch
from raytracer_tpu.ops.cluster import build_sah2_clustered as jax_build_sah2_clustered
from raytracer_tpu.ops.cluster import refit_lbvh2_clustered as jax_refit
from raytracer_tpu.ops.collapse import bvh2_as_bvh4 as jax_bvh2_as_bvh4
from raytracer_tpu.ops.collapse import collapse_apply_refit as jax_apply_refit
from raytracer_tpu.ops.collapse import collapse_plan as jax_collapse_plan
from raytracer_tpu.ops.lbvh import build_lbvh2 as jax_build_lbvh2
from raytracer_tpu.ops.pallas.traverse import make_qnodes as jax_make_qnodes
from raytracer_tpu.ops.trace import make_wide_bvh as jax_make_wide_bvh
from raytracer_tpu.render import render_ldr as jax_render_ldr
from raytracer_tpu.render import render_ldr_brute as jax_render_ldr_brute
from raytracer_tpu.render_pt import pt_sample_frame as jax_pt_sample_frame
from raytracer_tpu_torch.native import bvhtool
from raytracer_tpu_torch.render import render_ldr_brute
from raytracer_tpu_torch.utils import procgen
from test_torch_progressive import jax_uniforms
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MIN_RAY_MATCH = 0.9999
QUAT = np.asarray(suite.QUAT, np.float32)
sys.path.insert(0, str(ROOT / "tools_torch"))
import make_suite_snapshot  # noqa: E402


def hits(tri) -> int:
    return int((np.asarray(tri) >= 0).sum())


def test_config1_hits_match_jax_render_ldr_and_brute_force():
    """Config 1's frame function (one raw K1c launch, plain on the CPU) at
    64×64 and 4 frames: per-frame hits against the JAX suite's CPU path and
    the port's brute force."""
    size, frames = 64, 4
    tris, qn = suite.config1_records(CPU)
    got = suite.config1_frames(qn, size, frames)().tolist()
    jt = jnp.asarray(tris.numpy())
    wide = jax_make_wide_bvh(jax_bvh2_as_bvh4(jax_build_lbvh2(jt)))
    for i in range(frames):
        pos = (1e-3 * i, 0.0, suite.C1_Z)
        ref = hits(jax_render_ldr(wide, jt, np.asarray(pos, np.float32), QUAT, size, size)[2])
        assert abs(got[i] - ref) <= (1 - MIN_RAY_MATCH) * size * size, (i, got[i], ref)
        assert got[i] == hits(render_ldr_brute(tris, pos, suite.QUAT, size, size)[2]), i


def test_config5_records_and_hits_match_the_jax_chain():
    """Config 5 at toy size (icosphere(2), K = 8, 32×32, 2 frames): each
    frame's records bit-equal to the JAX chain's on the same deformed
    triangles, and each camera's hits against JAX brute force."""
    k, size = 8, 32
    dyn = suite.config5_build(CPU, k, procgen.make_icosphere(2))
    tris0 = jnp.asarray(dyn.tris0.numpy())
    cs, height = jax_build_sah2_clustered(tris0, k)
    plan = jax_collapse_plan(cs.bvh2, sweeps=height + 2)
    assert dyn.sweeps == height + 2
    run = suite.config5_frames(dyn, size, 1)
    cams, quats = suite.config5_cameras()
    for i in range(2):
        phase = suite.C5_STEP * i
        deformed = tris0 * jnp.float32(suite.deform_scale(phase))
        r = jax_refit(cs, deformed, num_sweeps=height + 2)
        ref = np.asarray(jax_make_qnodes(jax_make_wide_bvh(jax_apply_refit(
            plan, r.bvh2.bounds_u32)), r.tris_sorted, tri_ids=r.tri_order, leaf_size=k))
        ours = suite.config5_records(dyn, phase).numpy()
        assert np.array_equal(ours.view(np.int32), ref.view(np.int32).reshape(ours.shape)), \
            f"frame {i}: tolerance: bit-equal"
        got = run().tolist()
        for c, (cam, q) in enumerate(zip(cams, quats)):
            want = hits(jax_render_ldr_brute(deformed, np.asarray(cam, np.float32),
                                             np.asarray(q, np.float32), size, size)[2])
            assert abs(got[c] - want) <= (1 - MIN_RAY_MATCH) * size * size, (i, c, got[c], want)


SAMPLE_CASES = {
    "config2": (lambda: suite.normalized(procgen.make_icosphere(2)).triangles, suite.C2_POS,
                suite.C2_BOUNCES, {"own_widener": "promote"}),
    "config2_own_tree": (lambda: suite.normalized(procgen.make_icosphere(2)).triangles,
                         suite.C2_POS, suite.C2_BOUNCES, {"own_widener": "promote", "leaf": 1}),
    "config4": (suite.hall_triangles, suite.C4_POS, suite.C4_BOUNCES, {}),
    "config4_split_8wide": (suite.hall_triangles, suite.C4_POS, suite.C4_BOUNCES,
                            {"split": 0.25, "wide": 8}),
    "config4_own_tree": (suite.hall_triangles, suite.C4_POS, suite.C4_BOUNCES, {"leaf": 1}),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_config_sample_matches_jax_pt_sample_frame(case):
    """The sample of configs 2 and 4 (SAH K = 32 records, and the --split,
    --wide 8 and --leaf 1 records) at 32×32 with the camera wave at the JAX
    package's uniform offsets, against JAX's brute-force sample of the same
    key."""
    scene, pos, bounces, flags = SAMPLE_CASES[case]
    size, key = 32, jax.random.key(11)
    tris = scene()
    rec = suite.cluster_records(tris, CPU, **flags)
    ref, ref_stats = jax_pt_sample_frame(
        None, jnp.asarray(tris), jnp.asarray(pos, jnp.float32), jnp.asarray(QUAT), key, size,
        size, bounces=bounces, brute=True, stats=True)
    img, stats = suite.config_sample(rec, pos, size, bounces, tile_primary=False,
                                     uniforms=jax_uniforms(key, size, size, bounces))
    err = np.abs(img.numpy() - np.asarray(ref)).max(-1)
    share = float((err <= 1e-5).mean())
    assert share >= 0.99, f"{share:.4f} of pixels within 1e-5 (max |d| {err.max()})"
    assert int(stats["alive_rays"]) == int(ref_stats["alive_rays"])
    assert int(stats["lane_rays"]) == int(ref_stats["lane_rays"])


def emitted_metrics(path: Path) -> set[str]:
    """The metric names a JAX or port script prints: the first argument of
    its ``_emit`` calls and the strings of its ``"metric"`` entries."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "_emit" \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value)
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "metric":
                    names |= {n.value for n in ast.walk(v)
                              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    return names


def json_lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}


def test_metric_names_are_the_jax_scripts():
    assert emitted_metrics(ROOT / "bench_suite_torch.py") == emitted_metrics(
        ROOT / "bench_suite.py") == {"cornell_256_bvh2", "bunny_512_4spp_bvh4wide", "interior_nee_4bounce",
        "dynamic_refit_multicam"}
    assert emitted_metrics(ROOT / "bench_torch.py") == emitted_metrics(ROOT / "bench.py") == {
        "primary_rays_per_second_dragon_class_1080p", "primary_rays_per_second_quick"}


def test_bench_quick_prints_one_json_line(capsys):
    assert bench_torch.main(["--quick", "--device", "cpu", "--frames", "2", "--width", "96",
                             "--height", "64"]) == 0
    lines = json_lines(capsys.readouterr().out)
    assert len(lines) == 1 and set(lines[0]) == KEYS
    rec = lines[0]
    assert rec["metric"] == "primary_rays_per_second_quick" and rec["unit"] == "Mrays/s"
    d = rec["detail"]
    assert d["device"] == "cpu" and d["card"] is None and d["device_ms_per_frame"] is None
    assert d["resolution"] == [96, 64] and d["num_triangles"] == 5120 and d["leaf_size"] == 1
    assert 0 < d["hit_rate"] < 1 and math.isclose(rec["value"], 96 * 64 / d["ms_per_frame"] / 1e3,
                                                  abs_tol=0.006)


def test_suite_config1_prints_one_json_line(capsys):
    assert suite.main(["--config", "1", "--device", "cpu", "--frames", "2"]) == 0
    lines = json_lines(capsys.readouterr().out)
    assert len(lines) == 1 and set(lines[0]) == KEYS
    rec = lines[0]
    assert rec["metric"] == "cornell_256_bvh2" and rec["detail"]["frames"] == 2
    assert rec["detail"]["tris"] == 34 and rec["detail"]["device"] == "cpu"
    # 5 of the 65,536 rays graze a seam of the box from (0, 0, 2.2) (test docstring)
    assert rec["detail"]["hit_rate"] == 65531 / 65536


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(["--quick"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite.main(["--config", "1"])


def test_a_dragon_file_with_the_wrong_count_is_refused(tmp_path):
    glb = tmp_path / "dragon_standin.glb"
    procgen.write_glb(glb, procgen.make_icosphere(1))
    with pytest.raises(RuntimeError, match="80 triangles, not the 871200"):
        bench_torch.load_dragon(glb)


def test_a_failed_native_build_raises(monkeypatch):
    def failed():
        raise RuntimeError("native build failed")

    monkeypatch.setattr(bvhtool, "ensure_built", failed)
    with pytest.raises(RuntimeError, match="native build failed"):
        bench_torch.main(["--quick", "--device", "cpu", "--frames", "1"])
    with pytest.raises(RuntimeError, match="native build failed"):
        suite.cluster_records(suite.hall_triangles(), CPU)
    with pytest.raises(RuntimeError, match="native build failed"):
        suite.config5_build(CPU, 8, procgen.make_icosphere(1))


@pytest.mark.parametrize("flags", [
    {"split": 0.0}, {"split": -0.25}, {"split": float("nan")}, {"split": float("inf")},
    {"wide": 6}, {"wide": 2}, {"leaf": 0}, {"leaf": 1, "split": 0.25}, {"leaf": 1, "wide": 8}],
    ids=str)
def test_flags_out_of_range_raise(flags):
    with pytest.raises(ValueError):
        suite.cluster_records(suite.hall_triangles(), CPU, **flags)


def test_suite_cli_refuses_a_bad_width_before_any_work():
    with pytest.raises(ValueError, match="4 or 8"):
        suite.main(["--config", "4", "--device", "cpu", "--wide", "6"])


def test_snapshot_keeps_the_median_of_three_config1_processes():
    recs = [{"metric": "cornell_256_bvh2", "value": v, "detail": {}} for v in (7.0, 5.0, 6.0)]
    med = make_suite_snapshot.median_record(recs)
    assert med["value"] == 6.0 and med["detail"]["fresh_process_values"] == [5.0, 6.0, 7.0]
    assert med["detail"]["unresolved"]  # 7 / 5 spreads more than 10%
    recs = [{"metric": "interior_nee_4bounce", "value": v, "detail": {}} for v in (101, 100, 110)]
    med = make_suite_snapshot.median_record(recs)
    assert med["value"] == 101 and not med["detail"]["unresolved"]
    assert set(make_suite_snapshot.FRESH_PROCESSES) == set(suite.CONFIGS)
