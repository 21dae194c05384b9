"""The port's host modules against their JAX-package originals: the NumPy
fp16 codec, procgen, image IO, RenderConfig, FPSCamera, Scene, the artifact
formats, the profiling utilities, and PathTracer's artifacts and checkpoints
(read across the two packages both ways).

Tolerances: bit-equal codec outputs, byte-equal arrays, files and PNGs,
bit-equal camera state; checkpointed trees give byte-equal records and
images.
"""

import json

import numpy as np
import pytest
import torch

from raytracer_tpu import PathTracer as JaxPathTracer
from raytracer_tpu.io import artifacts as jax_artifacts
from raytracer_tpu.models.camera import FPSCamera as JaxFPSCamera
from raytracer_tpu.models.scene import Scene as JaxScene
from raytracer_tpu.utils import fp16 as jax_fp16
from raytracer_tpu.utils import image as jax_image
from raytracer_tpu.utils import procgen as jax_procgen
from raytracer_tpu.utils.config import CameraConfig as JaxCameraConfig
from raytracer_tpu.utils.config import RenderConfig as JaxRenderConfig
from raytracer_tpu_torch import FPSCamera, PathTracer, Scene
from raytracer_tpu_torch.io import artifacts
from raytracer_tpu_torch.utils import fp16, image, procgen, profiling
from raytracer_tpu_torch.utils.config import CameraConfig, RenderConfig
from torch_parity import CAM_POS, CAM_QUAT, FOV, seeded_scene

SEED = 53


def seeded_f32() -> np.ndarray:
    """Seeded f32 across the fp16 range and beyond, with ±0, ±inf, NaN,
    f32 and fp16 subnormals and the values next to the fp16 limits."""
    rng = np.random.default_rng(SEED)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40, 5.96e-8,
                        6.1e-5, -6.1e-5, 65504.0, -65504.0, 65519.0, 65520.0, 1e9, -1e9, 1.0,
                        -1.0], np.float32)
    return np.concatenate([
        special, rng.uniform(-7e4, 7e4, 4000).astype(np.float32),
        rng.uniform(-1e-4, 1e-4, 4000).astype(np.float32),
        (rng.standard_normal(4000) * np.exp(rng.uniform(-40, 40, 4000))).astype(np.float32),
    ])


ALL_F16 = np.arange(1 << 16, dtype=np.uint32)
CODEC = {
    "f32_to_f16_bits_rne": lambda m, x: m.f32_to_f16_bits_rne(x),
    "f32_to_f16_bits_trunc": lambda m, x: m.f32_to_f16_bits_trunc(x),
    "pack16x2_rne": lambda m, x: m.pack16x2_rne(x, x[::-1]),
    "pack16x2_trunc": lambda m, x: m.pack16x2_trunc(x, x[::-1]),
    "increment_f16_up": lambda m, x: getattr(m, "increment_f16_np", m.increment_f16)(x, True),
    "increment_f16_down_3": lambda m, x: getattr(m, "increment_f16_np", m.increment_f16)(
        x, False, 3),
    "pack_bounds_u32": lambda m, x: m.pack_bounds_u32(x[:-1].reshape(-1, 2, 3)[:, 0],
                                                      x[:-1].reshape(-1, 2, 3)[:, 1]),
    "pack_bounds_u32_trunc": lambda m, x: m.pack_bounds_u32(
        x[:-1].reshape(-1, 2, 3)[:, 0], x[:-1].reshape(-1, 2, 3)[:, 1], trunc=True),
    # every fp16 pattern
    "f16_bits_to_f32": lambda m, _: m.f16_bits_to_f32(ALL_F16.astype(np.uint16)),
    "f16_ordered_from_bits": lambda m, _: m.f16_ordered_from_bits(ALL_F16),
    "f16_bits_from_ordered": lambda m, _: m.f16_bits_from_ordered(ALL_F16),
    "unpack16x2": lambda m, _: np.stack([m.unpack16x2(ALL_F16 | (ALL_F16[::-1] << 16), i)
                                         for i in (0, 1)]),
    "unpack_bounds_u32": lambda m, _: np.stack(m.unpack_bounds_u32(
        (ALL_F16 | (ALL_F16[::-1] << 16))[:-1].reshape(-1, 3))),
}


@pytest.mark.filterwarnings("ignore:overflow encountered in cast:RuntimeWarning")
@pytest.mark.parametrize("name", list(CODEC))
def test_fp16_numpy_codec_bit_equal(name):
    x = seeded_f32()
    ours, ref = CODEC[name](fp16, x), CODEC[name](jax_fp16, x)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("name,args", [("make_cube", ()), ("make_cube", (2.5,)),
                                       ("make_quad", (1.5, -0.25)), ("make_cornell_box", ()),
                                       ("make_cornell_box", (4.0,)), ("make_trefoil", (48, 24)),
                                       ("make_icosphere", (2, 0.7))])
def test_procgen_byte_equal(name, args):
    ours, ref = getattr(procgen, name)(*args), getattr(jax_procgen, name)(*args)
    assert ours.dtype == ref.dtype == np.float32 and ours.tobytes() == ref.tobytes()


def test_image_io_byte_equal(tmp_path):
    """encode_png of grey, grey+alpha, rgb and rgba images; write_png and
    write_ppm files; read_ppm of them."""
    rng = np.random.default_rng(SEED)
    for c in (None, 2, 3, 4):
        img = rng.integers(0, 256, (17, 23) if c is None else (17, 23, c), dtype=np.uint8)
        assert image.encode_png(img) == jax_image.encode_png(img)
        assert image.encode_png(img, level=9) == jax_image.encode_png(img, level=9)
    img = rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)
    image.write_png(tmp_path / "a.png", img)
    jax_image.write_png(tmp_path / "b.png", img)
    image.write_ppm(tmp_path / "a.ppm", img)
    jax_image.write_ppm(tmp_path / "b.ppm", img)
    for ext in ("png", "ppm"):
        assert (tmp_path / f"a.{ext}").read_bytes() == (tmp_path / f"b.{ext}").read_bytes()
    assert np.array_equal(image.read_ppm(tmp_path / "a.ppm"), img[..., :3])
    with pytest.raises(ValueError):
        image.encode_png(img.astype(np.float32))


def test_render_config_equal():
    assert RenderConfig().to_dict() == JaxRenderConfig().to_dict()
    kw = dict(width=64, height=48, fov_degrees=55.0, widener="promote", spp=4)
    cam = dict(position=(0.0, 0.0, 3.5), fly=False)
    assert (RenderConfig(**kw, camera=CameraConfig(**cam)).to_dict()
            == JaxRenderConfig(**kw, camera=JaxCameraConfig(**cam)).to_dict())


@pytest.mark.parametrize("fly", [True, False])
def test_fps_camera_scripted_sequence_bit_equal(fly):
    """A scripted sequence of key presses, releases and mouse moves, each
    followed by an update: position, rotation and to_array bit-equal after
    every step."""
    rng = np.random.default_rng(SEED)
    cams = [cls(position=(0.1, 1.6, 5.0), fly=fly) for cls in (FPSCamera, JaxFPSCamera)]
    keys = ["KeyW", "KeyA", "KeyS", "KeyD", "KeyQ", "KeyE", "ShiftLeft", "ShiftRight"]
    for step in range(60):
        action = step % 4
        key = keys[int(rng.integers(len(keys)))]
        dx, dy = (float(v) for v in rng.normal(0.0, 80.0, 2))
        dt = float(rng.uniform(0.005, 0.05))
        for cam in cams:
            if action == 0:
                cam.press(key)
            elif action == 1:
                cam.move_mouse(dx, dy)
            elif action == 2 and step % 12 == 2:
                cam.release(key)
            elif step == 31:
                cam.clear_keys()
            cam.update(dt)
        ours, ref = cams
        assert ours.position.tobytes() == ref.position.tobytes()
        assert ours.rotation.tobytes() == ref.rotation.tobytes()
        assert np.array_equal(np.asarray(ours.to_array()), np.asarray(ref.to_array()))
    assert cams[0].fly == fly


def test_scene_host_methods_equal():
    tris = seeded_scene(2)
    ours, ref = Scene().set_triangles(tris), JaxScene().set_triangles(tris)
    assert ours.centroids().tobytes() == ref.centroids().tobytes()
    assert ours.get_triangles_float32().tobytes() == ref.get_triangles_float32().tobytes()
    ours.sort_triangles()
    ref.sort_triangles()
    assert ours.triangles.tobytes() == ref.triangles.tobytes()
    assert Scene().centroids().shape == (0, 3)


def test_artifact_functions_byte_equal(tmp_path):
    """bvh2_to_u32 / bvh2_from_u32 / bvh4_to_u32 / bvh4_from_u32, the u32
    files, the npz and the JSON dump, on seeded words."""
    rng = np.random.default_rng(SEED)
    m = 37
    words = rng.integers(0, 2**32, (m, 8), dtype=np.uint64).astype(np.uint32)
    b2 = (words[:, :3], words[:, 3], words[:, 4], words[:, 5])
    b4 = (words[:, :3], words[:, 3:7], words[:, 7])
    for mod in (artifacts, jax_artifacts):
        assert mod.bvh2_to_u32(*b2).tobytes() == jax_artifacts.bvh2_to_u32(*b2).tobytes()
        assert mod.bvh4_to_u32(*b4).tobytes() == jax_artifacts.bvh4_to_u32(*b4).tobytes()
    buf2, buf4 = artifacts.bvh2_to_u32(*b2), artifacts.bvh4_to_u32(*b4)
    for a, b in zip(artifacts.bvh2_from_u32(buf2), jax_artifacts.bvh2_from_u32(buf2)):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(artifacts.bvh4_from_u32(buf4), jax_artifacts.bvh4_from_u32(buf4)):
        assert a.tobytes() == b.tobytes()
    artifacts.save_u32_bin(tmp_path / "a.bin", buf2)
    jax_artifacts.save_u32_bin(tmp_path / "b.bin", buf2)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    assert np.array_equal(artifacts.load_u32_bin(tmp_path / "b.bin"), buf2)
    tris = seeded_scene(1)
    artifacts.save_scene_npz(tmp_path / "a.npz", tris, bvh2_left=words[:, 3])
    back = jax_artifacts.load_scene_npz(tmp_path / "a.npz")
    assert back["triangles"].tobytes() == tris.tobytes()
    assert back["bvh2_left"].tobytes() == words[:, 3].tobytes()
    # a JSON dump needs finite boxes: pack seeded ones
    bounds = fp16.pack_bounds_u32(*np.sort(rng.uniform(-2, 2, (2, m, 3)).astype(np.float32),
                                           axis=0))
    for stride, buf in ((6, artifacts.bvh2_to_u32(bounds, *b2[1:])),
                        (8, artifacts.bvh4_to_u32(bounds, *b4[1:]))):
        assert artifacts.bvh_to_json_dict(buf, stride=stride) == \
            jax_artifacts.bvh_to_json_dict(buf, stride=stride)
        artifacts.dump_bvh_json(tmp_path / "a.json", buf, stride=stride)
        jax_artifacts.dump_bvh_json(tmp_path / "b.json", buf, stride=stride)
        assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


@pytest.fixture(scope="module")
def k1_pair():
    """The port's PathTracer() and the JAX package's on the same seeded
    scene: the single-triangle Morton LBVH of both defaults."""
    tris = seeded_scene(3)
    pair = (PathTracer(64, 48, device="cpu"), JaxPathTracer(64, 48))
    for pt in pair:
        pt.build_bvh(tris)
        aim(pt)
    return pair


def aim(pt):
    pt.set_camera_position(*CAM_POS)
    pt.set_camera_quaternion(*CAM_QUAT)
    pt.fov_degrees = FOV
    return pt


def test_pathtracer_artifacts_byte_equal(k1_pair, tmp_path):
    """bvh2_artifact, bvh4_artifact and dump_bvh_json of the same K = 1
    build, byte for byte; a scene that traces brute force has none."""
    pt, jpt = k1_pair
    assert pt.bvh2_artifact().tobytes() == jpt.bvh2_artifact().tobytes()
    assert pt.bvh4_artifact().tobytes() == jpt.bvh4_artifact().tobytes()
    pt.dump_bvh_json(tmp_path / "a.json")
    jpt.dump_bvh_json(tmp_path / "b.json")
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    assert json.loads((tmp_path / "a.json").read_text())["numNodes"] == pt._bvh2.num_nodes
    tiny = PathTracer(16, 16, device="cpu").initialize()
    assert tiny.bvh2_artifact().tolist() == tiny.bvh4_artifact().tolist() == [0]


def test_checkpoints_cross_load_k1(k1_pair, tmp_path):
    """A K = 1 checkpoint written by either package loads into the other
    (no rebuild): the same BVH2 image and records, and the same frame."""
    pt, jpt = k1_pair
    pt.save_checkpoint(tmp_path / "port.npz")
    jpt.save_checkpoint(tmp_path / "jax.npz")
    a = jax_artifacts.load_scene_npz(tmp_path / "port.npz")
    b = jax_artifacts.load_scene_npz(tmp_path / "jax.npz")
    assert a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)
    into_jax = aim(JaxPathTracer(64, 48))
    into_jax.load_checkpoint(tmp_path / "port.npz")
    into_port = aim(PathTracer(64, 48, builder="sah", leaf_size=8, device="cpu"))
    into_port.load_checkpoint(tmp_path / "jax.npz")
    assert into_port.leaf_size == 1 and into_jax.leaf_size == 1
    assert into_jax.bvh2_artifact().tobytes() == pt.bvh2_artifact().tobytes()
    assert torch.equal(into_port._qnodes, pt._qnodes)
    assert np.array_equal(np.asarray(into_jax.render()), np.asarray(jpt.render()))
    assert torch.equal(into_port.render(), pt.render())


def test_checkpoints_cross_load_sah_k8(tmp_path):
    """SAH K = 8 (tri_order and leaf_size saved): the files of both packages
    hold the same arrays; each package's load of the other's file makes the
    same records (the JAX package renders K > 1 only through the Pallas
    kernel, so its side is held by records), and the port's frame from the
    JAX file equals its own."""
    tris = seeded_scene(3)
    pt = aim(PathTracer(64, 48, builder="sah", leaf_size=8, device="cpu"))
    jpt = JaxPathTracer(64, 48, builder="sah", leaf_size=8)
    pt.build_bvh(tris)
    jpt.build_bvh(tris)
    pt.save_checkpoint(tmp_path / "port.npz")
    jpt.save_checkpoint(tmp_path / "jax.npz")
    a = jax_artifacts.load_scene_npz(tmp_path / "port.npz")
    b = jax_artifacts.load_scene_npz(tmp_path / "jax.npz")
    assert a.keys() == b.keys() and "tri_order" in a
    assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a)
    into_jax = JaxPathTracer(64, 48)
    into_jax.load_checkpoint(tmp_path / "port.npz")
    into_port = aim(PathTracer(64, 48, device="cpu"))
    into_port.load_checkpoint(tmp_path / "jax.npz")
    assert into_jax.leaf_size == into_port.leaf_size == 8
    ref_qn = np.asarray(jpt._qnodes)
    ref_qn = ref_qn.reshape(ref_qn.shape[0], -1).view(np.uint32)
    got = np.asarray(into_jax._qnodes)
    assert np.array_equal(got.reshape(got.shape[0], -1).view(np.uint32), ref_qn)
    assert np.array_equal(into_port._qnodes.numpy().view(np.uint32), ref_qn)
    assert torch.equal(into_port.render(), pt.render())


def test_profiling_utilities(tmp_path):
    """sync waits on CUDA tensors only; FrameStats reports at its interval
    and totals the run; span records nothing while tracing is off;
    trace_annotated writes a Chrome trace of the block with the block's
    spans beside it (a no-op without a directory)."""
    x = torch.ones(3)
    profiling.sync(x, None, 3)
    stats = profiling.FrameStats(4, 2, report_every=0.0)
    rec = stats.tick(quiet=True)
    assert rec["mrays_per_s"] == round(rec["fps"] * 8 / 1e6, 2)
    assert profiling.FrameStats(4, 2, report_every=60.0).tick(quiet=True) is None
    stats.tick(quiet=True)
    run = stats.summary()
    assert run["frames"] == 2 and run["fps"] > 0
    with profiling.span("rt/off"):
        x = x * 2
    assert profiling.collect() == {"spans": [], "counters": {}}
    with profiling.trace_annotated(None):
        pass
    with profiling.trace_annotated(tmp_path / "prof"):
        with profiling.span("rt/on"):
            (torch.ones(64) @ torch.ones(64)).item()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "rt/on" for e in trace["traceEvents"])
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert [s["name"] for s in spans["spans"]] == ["rt/on"] and spans["counters"] == {}
