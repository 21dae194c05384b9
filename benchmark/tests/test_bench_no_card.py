"""``run.py`` refuses to measure without a card, never falls back to the
CPU, and fails in a directory that holds only the benchmark; nothing it
loads is JAX or the JAX package."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, REPO

GUARD = """
import sys, time
sys.path[:0] = [{bench!r}, {repo!r}]
import harness, common, devtrace, scenes, workcount, trafficbase
from reference import camera, intersect, render
for kind in ("orbit", "progressive", "deform"):
    common.load_module(common.HERE / "traffic" / (kind + ".py"), "traffic_" + kind)
for path in sorted((common.HERE / "metrics").glob("*.py")):
    common.load_module(path, "metric_" + path.stem)
for path in sorted((common.HERE / "generators").glob("*.py")):
    common.load_module(path, "generator_" + path.stem)
over = {{"config": {{"scene": {{"args": {{"nu": 8, "nv": 8}}}}, "width": 32, "height": 32}},
        "cell": {{"warmup_frames": 1, "check": {{"pixels": 16, "frames": 2}}}}}}
harness.run_once("dragon.orbit", 1, 0.2, True, "cpu", t0=time.perf_counter(),
                 overrides=over)
import run
print("FOUND", run.loaded_forbidden())
"""


def _cpu_only_env() -> dict:
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_run_exits_without_a_result_when_there_is_no_card():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dragon.orbit",
                        "--seed", "2147483714", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300, env=_cpu_only_env())
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA card" in r.stderr


def test_fails_in_a_directory_with_only_the_benchmark(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys, time; sys.path[:0] = ['benchmark', '.']; import harness; "
            "harness.run_once('dragon.orbit', 1, 0.2, False, 'cpu', t0=time.perf_counter())")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and "raytracer_tpu_torch" in r.stderr
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dragon.orbit",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=_cpu_only_env())
    assert r.returncode != 0 and not r.stdout.strip()


def test_nothing_loaded_is_jax_or_the_jax_package():
    code = GUARD.format(bench=str(BENCH), repo=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "FOUND []"


@pytest.mark.parametrize("name,found", [("raytracer_tpu_torch.ops", False),
                                        ("raytracer_tpu", True), ("raytracer_tpu.ops", True),
                                        ("jax._src", True), ("jaxlib", True), ("flax", True),
                                        ("jaxtyping", False)])
def test_the_guard_compares_whole_top_level_names(name, found, monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, name, object())
    assert (name in run.loaded_forbidden()) == found
    json.dumps(run.loaded_forbidden())
