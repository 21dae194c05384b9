"""Config 4 at Sponza class and the two cells added with it, at toy size on
the CPU: the frozen scene generator against the project's, the full scene
pinned, both cells end to end against the reference (and their controls
not), two planted faults of the 4-bounce NEE path, and the readers of the
program's counters with nothing counted."""

import hashlib
import json

import numpy as np
import pytest
from common import reader_of
from conftest import BENCH, run_toy, toy_overrides
from test_bench_readers import run_of
from test_bench_scenes import FORBIDDEN, _imports

import raytracer_tpu_torch.pathtracer as pathtracer
import raytracer_tpu_torch.render_pt as render_pt

CONFIG = "sponza_atrium_sah32_1080p"
CELLS = ["atrium.nee4", "dragon.orbit_sparse"]
# make_scene's triangles of the configuration, normalized
SCENE_SHA256 = "a6691e202bccfce9ff17801388b3410e818e84bf79e9f8152e1d0dae870f11e0"


def _config() -> dict:
    return json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())


def test_the_frozen_generator_makes_the_projects_atrium_at_the_toy_size():
    import scenes
    from raytracer_tpu_torch.utils import procgen

    args = toy_overrides("atrium.nee4")["config"]["scene"]["args"]
    made = scenes.generator_of("sponza_atrium")(**args)
    assert made.tobytes() == procgen.make_sponza_atrium(**args).tobytes()


def test_the_configurations_scene_is_pinned():
    import scenes

    cfg = _config()
    tris = scenes.make_scene(cfg["scene"])
    assert tris.dtype == np.float32 and tris.shape == (cfg["triangles"], 3, 3)
    assert hashlib.sha256(tris.tobytes()).hexdigest() == SCENE_SHA256


def test_the_import_scan_covers_the_atrium_generator():
    path = BENCH / "generators" / "sponza_atrium.py"
    assert path in sorted((BENCH / "generators").glob("*.py"))
    assert _imports(path) and not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("cell", CELLS)
def test_a_new_cell_is_correct_end_to_end_and_its_control_not(cell):
    out = run_toy(cell, seed=2147483777)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert run_toy(cell, control=True)["correct"] is False


def _nee_skipped(mp):
    """Every NEE shadow ray reported blocked: no direct light anywhere."""
    mp.setattr(render_pt, "_occluded", lambda qnodes, tris, o, *a, **k:
               o.new_ones(o.shape[0], dtype=bool))


def _fourth_bounce_left_out(mp):
    real = pathtracer.pt_sample_frame
    mp.setattr(pathtracer, "pt_sample_frame",
               lambda *a, bounces, **k: real(*a, bounces=min(bounces, 3), **k))


@pytest.mark.parametrize("fault", [_nee_skipped, _fourth_bounce_left_out],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_of_the_interior_comes_out_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run_toy("atrium.nee4")
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["sample_mismatch"]["value"] > out["checks"]["sample_mismatch"]["limit"]


def test_a_traced_toy_run_reads_the_counters():
    out = run_toy("atrium.nee4", trace=True)
    metrics = out["metrics"]
    assert 0.0 < metrics["k2_alive_share.interior"]["value"] < 100.0
    assert 30.0 <= metrics["shadow_blocked_share.interior"]["value"] <= 90.0


@pytest.mark.parametrize("spans", [{}, {"rt/k2/lanes": [0], "rt/k2/active": [0]},
                                   {"rt/k2/lanes": [200], "rt/k2/active": [50]}],
                         ids=["none", "no_lane", "k2_only"])
def test_the_counter_readers_read_none_without_their_counters(spans):
    run = run_of(spans=spans)
    share = reader_of("k2_alive_share.interior")(run)
    assert share == (25.0 if spans.get("rt/k2/lanes") == [200] else None)
    assert reader_of("shadow_blocked_share.interior")(run) is None


def test_the_counter_readers_sum_over_what_was_counted():
    run = run_of(spans={"rt/k2/lanes": [300, 100], "rt/k2/active": [150, 50],
                        "rt/pt/shadow/cast": [80, 20], "rt/pt/shadow/blocked": [60, 15]})
    assert reader_of("k2_alive_share.interior")(run) == pytest.approx(50.0)
    assert reader_of("shadow_blocked_share.interior")(run) == pytest.approx(75.0)

