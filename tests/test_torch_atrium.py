"""The Sponza-class atrium (``procgen.make_sponza_atrium``) and the NEE
shadow counters of ``pt_sample_frame`` (``rt/pt/shadow/cast``,
``rt/pt/shadow/blocked``), on the CPU: the scene is deterministic and has the
benchmark configuration's count, its toy size renders as an interior through
the port's 4-bounce path, the counters are exact on scenes whose answer is
known, and counting changes no pixel."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import PathTracer, pt_sample_frame
from raytracer_tpu_torch.models.scene import Scene
from raytracer_tpu_torch.utils import procgen, profiling
from torch_parity import one_torch_thread  # noqa: F401

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs" /
                     "sponza_atrium_sah32_1080p.json").read_text())
TOY_DETAIL = 1
W, H = 64, 36
DOWN = (-0.5 ** 0.5, 0.0, 0.0, 0.5 ** 0.5)  # looking along -y


@pytest.fixture(autouse=True)
def nothing_left():
    profiling.collect()
    yield
    profiling.collect()


def _tiles(n: int) -> np.ndarray:
    """The square [-1, 1]² of the plane y = 0 as n × n quads (2·n² triangles):
    more than a leaf's 32, so that the records hold more than one leaf."""
    step = 2.0 / n
    return np.concatenate([procgen.make_quad(step) + np.float32([x, 0.0, z])
                           for x in np.linspace(-1 + step / 2, 1 - step / 2, n)
                           for z in np.linspace(-1 + step / 2, 1 - step / 2, n)])


def _tracer(tris, pos, quat=(0.0, 0.0, 0.0, 1.0), normalize=False):
    if normalize:
        scene = Scene().set_triangles(tris)
        scene._normalize_enabled, scene._normalize_mode = True, "cube"
        scene.normalize_mesh()
        tris = scene.triangles
    assert len(tris) > 32  # the waves go through records of several leaves
    pt = PathTracer(W, H, "collapse", "sah", 32, device="cpu")
    pt.fov_degrees = 70.0
    pt.build_bvh(tris)
    pt.set_camera_position(*pos)
    pt.set_camera_quaternion(*quat)
    return pt


def _counted_sample(pt, bounces=4):
    with profiling.tracing(spans=False, counters=True):
        pt.render_progressive(bounces)
    return profiling.collect()["counters"]


@pytest.fixture(scope="module")
def atrium():
    cam = CONFIG["camera"]
    return _tracer(procgen.make_sponza_atrium(TOY_DETAIL), cam["position"], cam["quaternion"],
                   normalize=True)


def test_the_atrium_is_deterministic_with_the_configurations_count():
    args = CONFIG["scene"]["args"]
    a, b = procgen.make_sponza_atrium(**args), procgen.make_sponza_atrium(**args)
    assert a.dtype == np.float32 and a.shape == (CONFIG["triangles"], 3, 3)
    assert 256_000 <= len(a) <= 268_000
    assert a.tobytes() == b.tobytes()
    assert len(procgen.make_sponza_atrium(TOY_DETAIL)) == 18_178


def test_the_toy_atrium_is_an_interior_whose_sun_is_mostly_blocked(atrium):
    """From the configuration's view, camera rays hit on >= 90% of pixels,
    and of a 4-bounce sample's NEE shadow rays 30–90% are blocked."""
    _, _, tri = atrium._render_planes()
    assert float((tri >= 0).float().mean()) >= 0.9
    got = _counted_sample(atrium)
    cast, blocked = got["rt/pt/shadow/cast"], got["rt/pt/shadow/blocked"]
    assert 0 < blocked < cast
    assert 0.3 <= blocked / cast <= 0.9


def test_every_shadow_ray_in_a_closed_box_is_blocked():
    t = _tiles(4)
    box = np.concatenate([t + np.float32([0, s, 0]) for s in (-1, 1)]
                         + [t[..., [1, 0, 2]] + np.float32([s, 0, 0]) for s in (-1, 1)]
                         + [t[..., [0, 2, 1]] + np.float32([0, 0, s]) for s in (-1, 1)])
    got = _counted_sample(_tracer(box, (0.1, -0.2, 0.3)))
    assert got["rt/pt/shadow/cast"] > 0
    assert got["rt/pt/shadow/blocked"] == got["rt/pt/shadow/cast"]


def test_no_shadow_ray_from_a_floor_under_the_sun_is_blocked():
    """A tiled floor seen from above: every camera ray hits it, every hit
    faces the sun and nothing lies above it."""
    got = _counted_sample(_tracer(_tiles(6), (0.0, 0.6, 0.0), DOWN))
    assert got["rt/pt/shadow/cast"] == W * H
    assert got["rt/pt/shadow/blocked"] == 0


def test_counting_changes_no_output_of_a_sample(atrium):
    def sample():
        return pt_sample_frame(atrium._qnodes, atrium._tris_dev, atrium.camera_position,
                               atrium.camera_quaternion, W, H, bounces=4, leaf_k=32,
                               tile_primary=True, generator=torch.Generator().manual_seed(5))

    off = sample()
    with profiling.tracing(spans=True, counters=True):
        on = sample()
    assert profiling.collect()["counters"]["rt/pt/shadow/cast"] > 0
    assert off.numpy().tobytes() == on.numpy().tobytes()
