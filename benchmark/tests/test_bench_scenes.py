"""Scenes and toy sizes that a configuration brings as files: the built-ins
unchanged to the byte, a generator module found by name and run end to end,
the import rule of ``generators/``, and each configuration's CPU toy size."""

import ast
import hashlib
import json
import sys
import textwrap
from pathlib import Path

import conftest
import numpy as np
import pytest
from conftest import BENCH, REPO, run_toy, toy_overrides

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
FORBIDDEN = {"raytracer_tpu_torch", "raytracer_tpu", "jax", "jaxlib", "flax"}

# make_scene's triangles for each configuration, as the harness made them
# before configurations could bring generators of their own (a configuration
# added later pins its own scene in a test file of its own)
SCENE_SHA256 = {
    "dragon_sah32_1080p": "a2c21d210c33fb9dcc3c1525eb468c92f6014f3dcf6e52654d7274e2e2ad4b4c",
    "bunny_sah32_512": "ebc282e87d7cd9948421aaae2e45cca73129b8de85a93eaeac9f95264930e61a",
}
# the toy sizes the tests gave each configuration before they became files
TOY_SIZES = {
    "dragon_sah32_1080p": {"scene": {"args": {"nu": 16, "nv": 16}}, "width": 64, "height": 40},
    "bunny_sah32_512": {"scene": {"args": {"subdivisions": 2}}, "width": 64, "height": 64},
}

ROOM = '''
"""A toy room: four walls, a floor and a ball, open to the camera."""

import numpy as np

import scenes


def make(subdivisions=1, side=3.0):
    """Off the origin and wider than the unit cube, so that normalizing moves it."""
    s = side / 2.0
    corners = np.array([[-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
                        [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]], np.float32)
    quads = [[0, 1, 2, 3], [0, 4, 5, 1], [3, 2, 6, 7], [0, 3, 7, 4], [1, 5, 6, 2]]
    walls = np.concatenate([corners[[[a, b, c], [a, c, d]]] for a, b, c, d in quads])
    ball = scenes.make_icosphere(subdivisions, radius=0.4 * s)
    return (np.concatenate([walls, ball]) + np.float32([0.5, 0.25, 0.0])).astype(np.float32)
'''


def _imports(path: Path) -> set[str]:
    """The top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.fixture
def room(tmp_path, monkeypatch):
    """A generator module brought as a file, a configuration naming it, its
    toy size, and a BENCHMARK.json whose ``dragon.progressive3`` runs on it."""
    import scenes

    gens, toys = tmp_path / "generators", tmp_path / "toys"
    gens.mkdir()
    toys.mkdir()
    (gens / "toy_room_under_test.py").write_text(ROOM)
    monkeypatch.setattr(scenes, "GENERATORS_DIR", gens)
    monkeypatch.setattr(conftest, "TOYS", toys)
    cfg = json.loads((REPO / "benchmark/configs/dragon_sah32_1080p.json").read_text())
    cfg.update(name="toy_room", triangles=330,
               scene={"generator": "toy_room_under_test", "args": {"subdivisions": 2},
                      "normalize": "cube"})
    (tmp_path / "toy_room.json").write_text(json.dumps(cfg))
    (toys / "toy_room.json").write_text(json.dumps({"width": 48, "height": 32}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({**spec["configs"][0], "name": "toy_room",
                            "file": str(tmp_path / "toy_room.json")})
    next(w for w in spec["workloads"] if w["name"] == "dragon.progressive3")["config"] = "toy_room"
    yield {"spec": spec, "scene": cfg["scene"], "dir": gens}
    sys.modules.pop("generator_toy_room_under_test", None)


def _config(name: str) -> dict:
    conf = next(c for c in SPEC["configs"] if c["name"] == name)
    return json.loads((REPO / conf["file"]).read_text())


@pytest.mark.parametrize("name", sorted(SCENE_SHA256))
def test_make_scene_gives_the_configurations_triangles_unchanged_to_the_byte(name):
    import scenes

    cfg = _config(name)
    tris = scenes.make_scene(cfg["scene"])
    assert tris.dtype == np.float32 and tris.shape == (cfg["triangles"], 3, 3)
    assert hashlib.sha256(tris.tobytes()).hexdigest() == SCENE_SHA256[name]


def test_a_generator_module_is_found_by_name_and_normalized(room):
    import scenes

    made = scenes.generator_of("toy_room_under_test")(subdivisions=2)
    assert made.shape == (330, 3, 3) and made.dtype == np.float32
    tris = scenes.make_scene(room["scene"])
    assert not np.array_equal(tris, made)
    np.testing.assert_array_equal(tris, scenes.normalize_cube(made))
    extent = tris.reshape(-1, 3).max(0) - tris.reshape(-1, 3).min(0)
    assert float(extent.max()) == pytest.approx(2.0)


def test_a_cell_on_a_brought_scene_runs_end_to_end_and_is_judged(room):
    out = run_toy("dragon.progressive3", spec=room["spec"])
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    out = run_toy("dragon.progressive3", spec=room["spec"], control=True)
    assert out["correct"] is False, out["checks"]


def test_a_generator_that_makes_no_soup_is_refused(room):
    import scenes

    (room["dir"] / "toy_flat_under_test.py").write_text(
        "import numpy as np\n\ndef make():\n    return np.zeros((4, 9), np.float32)\n")
    try:
        with pytest.raises(ValueError, match="toy_flat_under_test"):
            scenes.make_scene({"generator": "toy_flat_under_test"})
    finally:
        sys.modules.pop("generator_toy_flat_under_test", None)


def test_an_unknown_generator_raises_naming_both_places_looked(tmp_path, monkeypatch):
    import scenes

    monkeypatch.setattr(scenes, "GENERATORS_DIR", tmp_path)
    with pytest.raises(KeyError) as err:
        scenes.make_scene({"generator": "no_such_scene", "args": {}})
    assert "scenes.py" in str(err.value) and str(tmp_path / "no_such_scene.py") in str(err.value)


def test_no_generator_module_imports_the_program_or_jax():
    for path in sorted((BENCH / "generators").glob("*.py")):
        assert not _imports(path) & FORBIDDEN, path


@pytest.mark.parametrize("line,bad", [
    ("import raytracer_tpu_torch.utils.procgen", True),
    ("from raytracer_tpu_torch.utils import procgen", True),
    ("from raytracer_tpu import scene", True),
    ("import jax.numpy as jnp", True),
    ("import numpy as np, jaxlib", True),
    ("import numpy as np\nimport scenes", False),
    ("import jaxtyping", False),
])
def test_the_import_scan_compares_whole_top_level_names(line, bad, tmp_path):
    path = tmp_path / "gen.py"
    path.write_text(textwrap.dedent(f"""
        def make():
            {line.replace(chr(10), chr(10) + ' ' * 12)}
    """))
    assert bool(_imports(path) & FORBIDDEN) == bad


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_every_configuration_has_a_toy_size_of_its_own_keys(conf):
    cfg = json.loads((REPO / conf["file"]).read_text())
    cell = next(w["name"] for w in SPEC["workloads"] if w["config"] == conf["name"])
    toy = toy_overrides(cell)["config"]
    assert set(toy) <= set(cfg) and set(toy.get("scene", {})) <= set(cfg["scene"])
    assert set(toy.get("scene", {}).get("args", {})) <= set(cfg["scene"].get("args", {}))


@pytest.mark.parametrize("name", sorted(TOY_SIZES))
def test_each_cell_keeps_the_toy_size_it_had(name):
    cells = [w["name"] for w in SPEC["workloads"] if w["config"] == name]
    assert cells and all(toy_overrides(c)["config"] == TOY_SIZES[name] for c in cells)


def test_a_missing_toy_file_is_reported_by_name(tmp_path, monkeypatch):
    monkeypatch.setattr(conftest, "TOYS", tmp_path)
    with pytest.raises(FileNotFoundError, match="dragon_sah32_1080p.json"):
        toy_overrides("dragon.orbit")
