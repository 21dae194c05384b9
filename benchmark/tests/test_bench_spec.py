"""BENCHMARK.json and every configuration, cell and metric file it names."""

import json
import re

import numpy as np
import pytest
from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(_line(w) for w in SPEC["command"])


def test_names_units_and_entry_keys():
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and isinstance(c["reduced"], list)
        assert len(c["reduced"]) <= 16 and len(set(c["reduced"])) == len(c["reduced"])
        assert all(isinstance(k, str) and NAME.match(k) for k in c["reduced"]), c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    import harness

    for cell in CELLS:
        e2e = {m["name"] for m in harness.metrics_for(SPEC, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = harness.metrics_for(SPEC, cell, True)
        assert layers and all(m["moves"] in e2e for m in layers)


def test_metric_readers_exist_and_roofline_names():
    for m in METRICS:
        # the metric's own reader, or that of its name before the first dot
        assert any((BENCH / "metrics" / f"{n}.py").is_file()
                   for n in (m["name"], m["name"].split(".", 1)[0])), m["name"]
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_parses_and_its_family_matches_its_metrics(cell):
    import harness

    _, entry, cfg, cellf = harness.spec_of(cell)
    assert (BENCH / "traffic" / f"{cellf['kind']}.py").is_file()
    assert cellf["why"] == entry["why"]
    family = "" if cellf["family"] == "device" else "." + cellf["family"]
    names = [m["name"] for m in harness.metrics_for(SPEC, cell, False) if m["name"] != "setup_s"]
    assert names and all(n.removeprefix(n.split(".")[0]) == family for n in names)
    assert set(cellf["check"]["limits"]) and cellf["check"]["frames"] >= 1
    assert cfg["name"] == entry["config"] and _line(cfg["source"])


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_scene_and_rays(conf):
    import scenes

    cfg = json.loads((REPO / conf["file"]).read_text())
    assert conf["file"].startswith("benchmark/configs/") and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"] and cfg["assumed"]
    # a cut names the configuration's own key that it changed
    assert set(cfg["reduced"]) <= set(cfg) - {"name", "source", "reduced"}
    gen = scenes.generator_of(cfg["scene"]["generator"])
    assert callable(gen) and cfg["triangles"] > 0
    w, h = cfg["width"], cfg["height"]
    rays = cfg["nominal_rays_per_frame"]["value"]
    assert isinstance(rays, int) and rays > 0 and rays % (w * h) == 0


def test_frozen_scenes_equal_the_project_generators_at_small_size():
    import scenes
    from raytracer_tpu_torch.utils import procgen

    np.testing.assert_array_equal(scenes.make_dragon_solid(12, 10), procgen.make_dragon_solid(12, 10))
    np.testing.assert_array_equal(scenes.make_icosphere(2), procgen.make_icosphere(2))
    assert scenes.make_dragon_solid().shape == (871200, 3, 3)
