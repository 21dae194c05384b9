"""The progressive sample's wave glue (``ops/cuda/wave.py``,
``csrc/wave_glue.cu``).

On the CPU: each wrapper runs its plain version on CPU tensors and counts no
launch, a whole sample on the CPU counts none, the wrappers refuse what the
kernels do not take, the shadow rays' directions are made once for a device
and a lane count, and the kernels are named as glue (no ``trace_tiles`` or
``trace_rays`` in their names, which the benchmark reads as K1 and K2).

On the card (``cuda``; needs neither JAX nor the JAX package):

    python -m pytest --noconftest -m cuda tests/test_torch_wave_kernels.py

each kernel equals its plain version run on the card, value for value
(NaN for NaN) on every output: the hit kernel on a camera wave (normals as
the columns of an (R, 3) array, every ray from one broadcast point) and on
a bounce wave (K2a's three planes), the bounce kernel on a middle wave, the
last wave in pixel order and in lane order, at 512×512 (whole 32×32 blocks)
and 1920×1080 (partial blocks), on seeded lanes that hold dead lanes,
misses, normals with n·d exactly 0, normals with n·l exactly 0 and, among
random normals, sums that round apart in another order of summation; and a
whole 3-bounce sample (plain, compacted and brute force) is sha256-equal
with the kernels and with the plain versions, counting one launch of each
kernel a wave.
"""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import Scene, render_pt
from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline
from raytracer_tpu_torch.ops.cuda import traverse, wave
from raytracer_tpu_torch.ops.shade import MISS_COLOR
from raytracer_tpu_torch.utils import procgen
from torch_parity import CAM_QUAT, FOV, one_torch_thread  # noqa: F401

CARD_SIZES = [(512, 512), (1920, 1080)]
SUN, BASE, SKY, EPS = render_pt._SUN, render_pt._BASE, render_pt._SKY, render_pt._EPS_OFFSET
KERNELS = ("wave_hit", "wave_bounce")
HALL_POS = (0.0, 0.0, 0.8)
SOURCE = Path(wave.__file__).resolve().parents[2] / "csrc" / "wave_glue.cu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wave kernels have no CPU mode")
    return torch.device("cuda")


def hit_wave(kind: str, r: int, seed: int, device) -> tuple:
    """Seeded inputs of :func:`wave.wave_hit` for R lanes, drawn on the CPU
    and moved to ``device``. ``kind`` "camera": the camera wave (every lane
    alive, one origin broadcast on ``device``, the normals the columns of an (R, 3) array
    as ``camera_lanes`` returns them); "bounce": a later wave (a quarter of
    the lanes dead, origins per lane, K2a's three planes). A fifth of the
    lanes miss (t 1e30, tri −1, a zero normal); of the rest a tenth have a
    normal with n·d exactly 0 and a tenth one with n·sun exactly 0 (sun's x
    and z are equal)."""
    g = torch.Generator().manual_seed(seed)
    d = torch.nn.functional.normalize(torch.randn((r, 3), generator=g), dim=-1)
    n = torch.nn.functional.normalize(torch.randn((r, 3), generator=g), dim=-1)
    kind_of = torch.randint(0, 10, (r,), generator=g)
    zero = torch.zeros(r)
    n = torch.where((kind_of == 1)[:, None], torch.stack([d[:, 1], -d[:, 0], zero], -1), n)
    c = torch.rand(r, generator=g) + 0.1
    n = torch.where((kind_of == 2)[:, None], torch.stack([c, zero, -c], -1), n)
    miss = kind_of >= 8
    n = torch.where(miss[:, None], 0.0, n)
    t = torch.where(miss, 1e30, torch.rand(r, generator=g) * 3.0 + 0.5)
    tri = torch.where(miss, -1, torch.randint(0, 1 << 20, (r,), generator=g, dtype=torch.int32))
    if kind == "camera":
        o = torch.tensor([[0.15, -0.1, 2.5]], device=device).expand(r, 3)
        alive = torch.ones(r, dtype=torch.bool)
        throughput, radiance = torch.ones((r, 3)), torch.zeros((r, 3))
    else:
        o = torch.randn((r, 3), generator=g).to(device)
        alive = torch.rand(r, generator=g) >= 0.25
        throughput = torch.rand((r, 3), generator=g)
        radiance = torch.rand((r, 3), generator=g)
    n = n.to(device)
    planes = n.unbind(1) if kind == "camera" else tuple(p.contiguous() for p in n.unbind(1))
    return (t.to(device), tri.to(device), planes, o, d.to(device), alive.to(device),
            throughput.to(device), radiance.to(device))


def bounce_wave(r: int, seed: int, device) -> tuple:
    """Seeded inputs of :func:`wave.wave_bounce` after a bounce hit wave:
    the plain hit wave's outputs, K2b's triangle plane (blocked on half the
    NEE lanes, −1 elsewhere), the draws with exact 0s among them."""
    t, tri, planes, o, d, alive, throughput, radiance = hit_wave("bounce", r, seed, device)
    n, hit, radiance, p, ndotl, nee = wave.wave_hit_reference(
        t, tri, planes, o, d, alive, throughput, radiance, sun=SUN, env=SKY, eps=EPS)
    g = torch.Generator().manual_seed(seed + 1)
    occ = torch.where(nee.cpu() & (torch.rand(r, generator=g) < 0.5),
                      torch.randint(0, 1000, (r,), generator=g, dtype=torch.int32), -1)
    u1, u2 = (torch.where(torch.rand(r, generator=g) < 0.05, 0.0,
                          torch.rand(r, generator=g)).to(device) for _ in range(2))
    return occ.to(device), hit, ndotl, throughput, radiance, n, p, o, d, u1, u2


def assert_same(ours, plain, names) -> None:
    """Each pair of outputs: the same dtype, shape and device, and equal
    value for value, NaN for NaN (a sum may end in 0 of either sign)."""
    for name, a, b in zip(names, ours, plain):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device, name
        same = a == b
        if a.is_floating_point():
            same |= a.isnan() & b.isnan()
        assert bool(same.all()), f"{name}: {int((~same).sum())} values differ"


def launches() -> dict:
    return {k: traverse.LAUNCHES[k] for k in KERNELS}


# -- on the CPU ----------------------------------------------------------------

def test_cpu_calls_run_the_plain_versions_and_count_no_launch():
    before = launches()
    args = hit_wave("bounce", 300, 1, "cpu")
    assert_same(wave.wave_hit(*args, sun=SUN, env=SKY, eps=EPS),
                wave.wave_hit_reference(*args, sun=SUN, env=SKY, eps=EPS),
                ("n", "hit", "radiance", "p", "ndotl", "nee"))
    args = bounce_wave(300, 2, "cpu")
    assert_same(wave.wave_bounce(*args, base=BASE), wave.wave_bounce_reference(*args, base=BASE),
                ("o", "d", "throughput", "alive", "radiance"))
    last = args[:5]
    assert_same([wave.wave_last(*last, base=BASE, sky=SKY, size=(20, 15))],
                [wave.wave_last_reference(*last, base=BASE, sky=SKY, size=(20, 15))], ["image"])
    assert launches() == before


def test_plain_hit_wave_holds_its_seeded_lanes():
    """The seeded lanes are what the card tests need: misses, dead lanes,
    normals turned and not, NEE lanes, and lanes of n·l exactly 0."""
    t, tri, planes, o, d, alive, throughput, radiance = hit_wave("bounce", 2000, 3, "cpu")
    n, hit, _, p, ndotl, nee = wave.wave_hit_reference(
        t, tri, planes, o, d, alive, throughput, radiance, sun=SUN, env=SKY, eps=EPS)
    raw = torch.stack(planes, -1)
    assert 0 < int(hit.sum()) < int(alive.sum()) < 2000
    assert 0 < int((n != raw).any(-1).sum()) < 2000
    assert 0 < int(nee.sum()) < int(hit.sum())
    assert int(((ndotl == 0) & hit & (raw[:, 0] == -raw[:, 2]) & (raw[:, 0] != 0)).sum()) > 0
    assert bool(torch.isfinite(p).all())


def test_a_cpu_sample_counts_no_wave_launch():
    tris = torch.from_numpy(procgen.make_icosphere(2))
    before = launches()
    img = render_pt.pt_sample_frame(None, tris, (0.0, 0.0, 2.5), CAM_QUAT, 24, 16, bounces=2,
                                    brute=True, generator=torch.Generator().manual_seed(3))
    assert img.shape == (16, 24, 3) and launches() == before


def test_shadow_directions_are_made_once_a_device_and_lane_count():
    a = render_pt._sun_dirs(torch.device("cpu"), 77)
    assert render_pt._sun_dirs(torch.device("cpu"), 77) is a
    assert torch.equal(a, torch.tensor(SUN).expand(77, 3))
    b = render_pt._sun_dirs(torch.device("cpu"), 78)
    assert b.shape == (78, 3) and b is not a


def test_the_kernels_are_named_as_glue():
    """The benchmark puts a device op in K1 or K2 by ``trace_tiles`` /
    ``trace_rays`` in its name, every other op in the glue."""
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s*(\w+)\(", SOURCE.read_text())
    assert names == ["wave_hit_kernel", "wave_bounce_kernel"]
    assert not any("trace_tiles" in k or "trace_rays" in k for k in names)


def _hit_case(i):
    t, tri, planes, o, d, alive, throughput, radiance = hit_wave("bounce", 64, 4, "cpu")
    bad = [
        dict(t=t[:-1]), dict(t=t.double()), dict(tri=tri.long()), dict(planes=planes[:2]),
        dict(planes=(planes[0], planes[1], torch.zeros(128)[::2])),
        dict(o=o.t().contiguous().t()), dict(d=d.t().contiguous().t()), dict(alive=alive.int()),
        dict(throughput=throughput[:, :2]), dict(radiance=radiance.double()),
    ][i]
    args = dict(t=t, tri=tri, planes=planes, o=o, d=d, alive=alive, throughput=throughput,
                radiance=radiance)
    args.update(bad)
    return args


@pytest.mark.parametrize("case", range(10))
def test_hit_wrapper_refuses_what_the_kernel_does_not_take(case):
    a = _hit_case(case)
    with pytest.raises(ValueError):
        wave.wave_hit(a["t"], a["tri"], a["planes"], a["o"], a["d"], a["alive"],
                      a["throughput"], a["radiance"], sun=SUN, env=SKY, eps=EPS)


@pytest.mark.parametrize("case", ["occ_long", "hit_int", "ndotl_short", "radiance_strided",
                                  "p_strided", "u1_double", "o_transposed", "size_mismatch",
                                  "size_zero"])
def test_bounce_wrappers_refuse_what_the_kernel_does_not_take(case):
    """The inputs of every wave (occ, hit, ndotl, radiance) refused by both
    wrappers; those of the bounce (p, u1, o) by wave_bounce; a size that is
    not the lanes' by wave_last."""
    occ, hit, ndotl, throughput, radiance, n, p, o, d, u1, u2 = bounce_wave(64, 5, "cpu")
    bad = {"occ_long": dict(occ=occ.long()), "hit_int": dict(hit=hit.int()),
           "ndotl_short": dict(ndotl=ndotl[:-1]),
           "radiance_strided": dict(radiance=torch.zeros((64, 6))[:, ::2]),
           "p_strided": dict(p=torch.zeros((64, 6))[:, ::2]), "u1_double": dict(u1=u1.double()),
           "o_transposed": dict(o=o.t().contiguous().t()), "size_mismatch": dict(size=(8, 9)),
           "size_zero": dict(size=(0, 64))}[case]
    a = dict(occ=occ, hit=hit, ndotl=ndotl, throughput=throughput, radiance=radiance, n=n, p=p,
             o=o, d=d, u1=u1, u2=u2, size=(8, 8))
    a.update(bad)
    lanes = [a[k] for k in ("occ", "hit", "ndotl", "throughput", "radiance")]
    if case not in ("size_mismatch", "size_zero"):
        with pytest.raises(ValueError):
            wave.wave_bounce(*lanes, a["n"], a["p"], a["o"], a["d"], a["u1"], a["u2"], base=BASE)
    if case not in ("p_strided", "u1_double", "o_transposed"):
        with pytest.raises(ValueError):
            wave.wave_last(*lanes, base=BASE, sky=SKY, size=a["size"])


def test_plain_versions_take_the_occlusion_mask():
    """The plain versions read a bool ``occ`` as the occlusion mask itself
    (blocked where True), as they read K2b's plane blocked where ≥ 0."""
    occ, *rest = bounce_wave(64, 6, "cpu")
    assert_same(wave.wave_bounce(occ >= 0, *rest, base=BASE), wave.wave_bounce(occ, *rest,
                                                                                 base=BASE),
                ("o", "d", "throughput", "alive", "radiance"))
    assert torch.equal(wave.blocked(occ), occ >= 0) and torch.equal(wave.blocked(occ >= 0),
                                                                    occ >= 0)


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("width,height", CARD_SIZES)
def test_hit_kernel_equals_plain_version_on_card(cuda_device, kind, width, height):
    args = hit_wave(kind, width * height, width + height, cuda_device)
    env = MISS_COLOR if kind == "camera" else SKY
    before = launches()
    ours = wave.wave_hit(*args, sun=SUN, env=env, eps=EPS)
    torch.cuda.synchronize()
    assert launches() == {**before, "wave_hit": before["wave_hit"] + 1}
    plain = wave.wave_hit_reference(*args, sun=SUN, env=env, eps=EPS)
    assert_same(ours, plain, ("n", "hit", "radiance", "p", "ndotl", "nee"))


@pytest.mark.cuda
@pytest.mark.parametrize("origin", ["broadcast", "per_lane"])
@pytest.mark.parametrize("width,height", CARD_SIZES)
def test_bounce_kernel_equals_plain_version_on_card(cuda_device, origin, width, height):
    r = width * height
    args = list(bounce_wave(r, width * 3 + height, cuda_device))
    if origin == "broadcast":
        args[7] = torch.tensor([[0.15, -0.1, 2.5]], device=cuda_device).expand(r, 3)
    before = launches()
    ours = wave.wave_bounce(*args, base=BASE)
    torch.cuda.synchronize()
    assert launches() == {**before, "wave_bounce": before["wave_bounce"] + 1}
    assert_same(ours, wave.wave_bounce_reference(*args, base=BASE),
                ("o", "d", "throughput", "alive", "radiance"))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["pixels", "lanes"])
@pytest.mark.parametrize("width,height", CARD_SIZES)
def test_last_wave_equals_plain_version_on_card(cuda_device, order, width, height):
    args = bounce_wave(width * height, width + 7, cuda_device)[:5]
    size = (width, height) if order == "pixels" else None
    before = launches()
    ours = wave.wave_last(*args, base=BASE, sky=SKY, size=size)
    torch.cuda.synchronize()
    assert launches() == {**before, "wave_bounce": before["wave_bounce"] + 1}
    assert_same([ours], [wave.wave_last_reference(*args, base=BASE, sky=SKY, size=size)],
                ["radiance"])


def hall(device):
    scene = Scene().set_triangles(procgen.make_interior_hall())
    scene.normalize_mesh()
    tris = scene.triangles
    qn = records_pipeline(build_sah2_clustered(tris, 8, device)[0])
    return qn, torch.from_numpy(np.ascontiguousarray(tris)).to(device)


def _digest(img: torch.Tensor) -> str:
    return hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tile", "compact", "brute"])
def test_sample_is_hash_equal_through_the_kernels_on_card(cuda_device, path, monkeypatch):
    """A 3-bounce sample of the interior hall through the kernels and
    through the plain versions, from the same generator state: the same
    sha256; one launch of each kernel a wave."""
    qn, tris = hall(cuda_device)
    width, height = (100, 70) if path != "brute" else (40, 30)

    def sample():
        gen = torch.Generator(device=cuda_device).manual_seed(41)
        return render_pt.pt_sample_frame(
            None if path == "brute" else qn, tris, HALL_POS, CAM_QUAT, width, height, bounces=3,
            fov_degrees=FOV, leaf_k=8, brute=path == "brute", tile_primary=path != "brute",
            compact=path == "compact", generator=gen)

    before = launches()
    ours = sample()
    torch.cuda.synchronize()
    assert launches() == {k: before[k] + 3 for k in KERNELS}
    monkeypatch.setattr(render_pt, "wave_hit", wave.wave_hit_reference)
    monkeypatch.setattr(render_pt, "wave_bounce", wave.wave_bounce_reference)
    monkeypatch.setattr(render_pt, "wave_last", wave.wave_last_reference)
    plain = sample()
    assert launches() == {k: before[k] + 3 for k in KERNELS}
    assert ours.shape == plain.shape == (height, width, 3)
    assert float(ours.sum()) > 0 and _digest(ours) == _digest(plain)
