"""The camera wave's lanes (``ops/cuda/camera.py``, ``csrc/camera_lanes.cu``).

On the CPU: the wrapper reads the camera row and runs its plain version,
the composition that ``pt_sample_frame`` ran before the kernel
(``generate_rays_jittered``, then ``img_to_lanes`` of the directions and of
K1b's five planes, then ``face``), bit for bit, at sizes that are multiples
of 32 and at sizes that are not; the kernel's lane → pixel arithmetic,
written here in torch, inverts ``lane_of_pixel``; the wrapper refuses what
the kernel does not take.

On the card (``cuda``; needs neither JAX nor the JAX package):

    python -m pytest --noconftest -m cuda tests/test_torch_camera_lanes.py

the kernel, reading the camera and the seed from a row on the card, equals
the plain version run on the card bit for bit (``torch.equal`` on d, t, tri
and n) at 1920×1080, 512×512 and 100×70 for three seeds, and a progressive
sample through it equals the sample through the plain version, counting
one ``camera_lanes`` launch. The seeded planes
hold misses (tri −1, a zero normal), normals with n·d exactly 0, and
normals whose n·d cancels to 0 in one order of summation and not in
another, so that the kernel's order of the sum is held to the one that
``face`` states.
"""

import pytest
import torch

from raytracer_tpu_torch import render_pt
from raytracer_tpu_torch.ops.camera import generate_rays_jittered
from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline
from raytracer_tpu_torch.ops.cuda import traverse
from raytracer_tpu_torch.ops.cuda.camera import camera_lanes, camera_lanes_reference
from raytracer_tpu_torch.ops.cuda.traverse import CAMERA_ROW, camera_row
from raytracer_tpu_torch.ops.lanes import TILE, face, img_to_lanes, lane_of_pixel
from torch_parity import CAM_POS, CAM_QUAT, FOV, seeded_scene

CPU_SIZES = [(64, 64), (96, 40), (100, 70)]
CARD_SIZES = [(1920, 1080), (512, 512), (100, 70)]
SEEDS = [0, 4_194_303, 1_234_567]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the camera wave's kernel has no CPU mode")
    return torch.device("cuda")


def row_of(width: int, height: int, pseed: int, device) -> torch.Tensor:
    """The camera row of the test camera's ``width`` × ``height`` frame with
    jitter seed ``pseed``, on ``device``."""
    return torch.tensor(camera_row(CAM_POS, CAM_QUAT, width, height, FOV, pseed),
                        dtype=torch.float32, device=device)


def plain_lanes(planes, row, width, height, fov_degrees):
    """The plain version with the camera and the seed read from ``row``."""
    values = row.tolist()
    return camera_lanes_reference(planes, values[3:7], width, height, fov_degrees,
                                  int(values[11]))


def seeded_planes(width: int, height: int, pseed: int, seed: int, device) -> list[torch.Tensor]:
    """K1b-like (t, nx, ny, nz, tri) planes of a frame: random hits, a fifth
    misses (t 1e30, tri −1, zero normal), and among the hits a tenth each
    of normals with n·d exactly 0 and of normals whose n·d cancels in one
    order of summation but not in another (d: the frame's jittered rays)."""
    g = torch.Generator().manual_seed(seed)
    shape = (height, width)
    dx, dy, dz = generate_rays_jittered(width, height, CAM_POS, CAM_QUAT, pseed, FOV,
                                        device=device)[1].unbind(-1)
    n = torch.nn.functional.normalize(torch.randn((*shape, 3), generator=g), dim=-1).to(device)
    kind = torch.randint(0, 10, shape, generator=g).to(device)
    tiny = (torch.randint(0, 2, shape, generator=g) * 2e-9 - 1e-9).to(device)
    zero = torch.zeros(shape, device=device)
    n = torch.where((kind == 1)[..., None], torch.stack([dy, -dx, zero], -1), n)
    n = torch.where((kind == 2)[..., None], torch.stack([dy, -dx, tiny], -1), n)
    n = torch.where((kind == 3)[..., None], torch.stack([dz, tiny, -dx], -1), n)
    n = torch.where((kind == 4)[..., None], torch.stack([tiny, dz, -dy], -1), n)
    miss = kind >= 8
    n = torch.where(miss[..., None], 0.0, n)
    t = torch.where(miss, 1e30, torch.rand(shape, generator=g).to(device) * 3.0 + 0.5)
    tri = torch.where(miss, -1, torch.randint(0, 1 << 20, shape, generator=g,
                                              dtype=torch.int32).to(device))
    return [t.contiguous(), *(c.contiguous() for c in n.unbind(-1)), tri.contiguous()]


def pixel_of_lane(width: int, height: int) -> torch.Tensor:
    """The kernel's lane → pixel arithmetic (csrc/camera_lanes.cu), in
    torch: (H·W,) row-major pixel of each lane."""
    lane = torch.arange(width * height)
    band = TILE * width
    by = lane // band
    in_band = lane - by * band
    block_h = torch.clamp_max(height - by * TILE, TILE)
    bx = in_band // (TILE * block_h)
    in_block = in_band - bx * TILE * block_h
    block_w = torch.clamp_max(width - bx * TILE, TILE)
    y = by * TILE + in_block // block_w
    x = bx * TILE + in_block % block_w
    return y * width + x


@pytest.mark.parametrize("width,height", CPU_SIZES)
def test_plain_version_is_the_sample_composition(width, height):
    """On CPU planes the wrapper runs the plain version, which gives the
    camera wave's old composition bit for bit, and counts no launch."""
    pseed = 3_000_017
    planes = seeded_planes(width, height, pseed, 11, "cpu")
    before = dict(traverse.LAUNCHES)
    d, t, tri, n = camera_lanes(planes, row_of(width, height, pseed, "cpu"), width, height, FOV)
    assert traverse.LAUNCHES == before
    d_old = img_to_lanes(generate_rays_jittered(width, height, CAM_POS, CAM_QUAT, pseed, FOV,
                                                device="cpu")[1], width, height)
    t_old, nx, ny, nz, tri_old = (img_to_lanes(p, width, height) for p in planes)
    n_old = face(torch.stack([nx, ny, nz], dim=-1), d_old)
    assert d.shape == n.shape == (width * height, 3) and tri.dtype == torch.int32
    for new, old in ((d, d_old), (t, t_old), (tri, tri_old), (n, n_old)):
        assert torch.equal(new, old)
    flipped = (n != torch.stack([nx, ny, nz], dim=-1)).any(-1)
    assert 0 < int(flipped.sum()) < width * height  # the planes turn some normals, not all


@pytest.mark.parametrize("width,height", CARD_SIZES)
def test_seeded_planes_tell_the_orders_of_the_sum_apart(width, height):
    """Each two orders of summing n·d's three products turn a different
    set of the seeded normals: so the card test holds the kernel's order to
    the one ``face`` states."""
    pseed = 9
    t, nx, ny, nz, _ = seeded_planes(width, height, pseed, 3, "cpu")
    d = generate_rays_jittered(width, height, CAM_POS, CAM_QUAT, pseed, FOV, device="cpu")[1]
    a, b, c = (torch.stack([nx, ny, nz], dim=-1) * d).unbind(-1)
    turned = [s > 0 for s in ((a + b) + c, (a + c) + b, a + (b + c))]
    assert all(bool((turned[i] != turned[j]).any()) for i in range(3) for j in range(i))


@pytest.mark.parametrize("width,height", CPU_SIZES)
def test_face_sums_n_dot_d_in_its_stated_order(width, height):
    """``face`` turns a normal exactly where (x + z) + y of n·d's products
    is positive, and leaves it where that sum is 0 or negative."""
    pseed = 21
    t, nx, ny, nz, _ = seeded_planes(width, height, pseed, 5, "cpu")
    n = torch.stack([nx, ny, nz], dim=-1)
    d = generate_rays_jittered(width, height, CAM_POS, CAM_QUAT, pseed, FOV, device="cpu")[1]
    a, b, c = (n * d).unbind(-1)
    turned = (a + c) + b > 0
    assert torch.equal(face(n, d), torch.where(turned[..., None], -n, n))
    assert bool(((a + c) + b != (a + b) + c).any())  # the planes tell the orders apart


@pytest.mark.parametrize("width,height", CPU_SIZES + [(1, 1), (33, 1), (31, 65), (1920, 1080)])
def test_kernel_lane_arithmetic_inverts_lane_of_pixel(width, height):
    lane = lane_of_pixel(width, height, "cpu")
    pixel = pixel_of_lane(width, height)
    assert torch.equal(pixel[lane], torch.arange(width * height))
    assert torch.equal(torch.sort(pixel).values, torch.arange(width * height))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    planes = seeded_planes(64, 32, 5, 1, "cpu")
    row = row_of(64, 32, 5, "cpu")
    with pytest.raises(ValueError):
        camera_lanes(planes[:4], row, 64, 32, FOV)
    with pytest.raises(ValueError):
        camera_lanes(planes, row, 32, 64, FOV)
    with pytest.raises(ValueError):
        camera_lanes([*planes[:4], planes[4].float()], row, 64, 32, FOV)
    with pytest.raises(ValueError):
        camera_row(CAM_POS, CAM_QUAT, 64, 32, FOV, 1 << 24)
    big_seed = row.clone()
    big_seed[11] = float(1 << 24)
    with pytest.raises(ValueError):
        camera_lanes(planes, big_seed, 64, 32, FOV)
    for bad in (row[:CAMERA_ROW - 1], row.double(), torch.stack([row, row], 1)[:, 0]):
        with pytest.raises(ValueError):
            camera_lanes(planes, bad, 64, 32, FOV)
    with pytest.raises(ValueError):
        camera_lanes([p.to(torch.float64) if i == 0 else p for i, p in enumerate(planes)],
                     row, 64, 32, FOV)
    with pytest.raises(ValueError):
        camera_lanes([planes[0].t().contiguous().t(), *planes[1:]], row, 64, 32, FOV)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width,height", CARD_SIZES)
def test_kernel_equals_plain_version_on_card(cuda_device, width, height, seed):
    planes = seeded_planes(width, height, seed, seed + 1, cuda_device)
    before = traverse.LAUNCHES["camera_lanes"]
    ours = camera_lanes(planes, row_of(width, height, seed, cuda_device), width, height, FOV)
    torch.cuda.synchronize()
    assert traverse.LAUNCHES["camera_lanes"] == before + 1
    plain = camera_lanes_reference(planes, CAM_QUAT, width, height, FOV, seed)
    for name, a, b in zip(("d", "t", "tri", "n"), ours, plain):
        assert a.device == b.device and a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} words differ"


@pytest.mark.cuda
@pytest.mark.parametrize("width,height", [(96, 64), (100, 70)])
def test_sample_through_kernel_equals_plain_sample(cuda_device, width, height, monkeypatch):
    """pt_sample_frame(tile_primary=True) through the kernel returns the
    image of the sample through the plain version (the code path before the
    kernel), and counts one camera_lanes launch a sample."""
    tris = seeded_scene(3)
    qn = records_pipeline(build_sah2_clustered(tris, 8, cuda_device)[0])
    tris_dev = torch.from_numpy(tris).to(cuda_device)

    def sample():
        gen = torch.Generator(device=cuda_device).manual_seed(77)
        return render_pt.pt_sample_frame(qn, tris_dev, CAM_POS, CAM_QUAT, width, height,
                                         bounces=3, fov_degrees=FOV, leaf_k=8,
                                         tile_primary=True, generator=gen)

    before = traverse.LAUNCHES["camera_lanes"]
    ours = sample()
    torch.cuda.synchronize()
    assert traverse.LAUNCHES["camera_lanes"] == before + 1
    monkeypatch.setattr(render_pt, "camera_lanes", plain_lanes)
    plain = sample()
    assert traverse.LAUNCHES["camera_lanes"] == before + 1
    assert torch.equal(ours, plain)
