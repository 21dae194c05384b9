"""The check's control and planted faults: a run at toy size on the CPU with
the timed path broken underneath must come out not correct, and the control
(the reference in bfloat16 in the program's place) too."""

import pytest
from conftest import run_toy

import raytracer_tpu_torch.ops.cuda.traverse as traverse
import raytracer_tpu_torch.pathtracer as pathtracer
from raytracer_tpu_torch import PathTracer

CELLS = ["dragon.orbit", "dragon.progressive3", "bunny.spp4", "dragon.deform8"]


def _unchanged_progressive(mp):
    """``render_progressive`` hands back the mean it had, sampling nothing."""
    real = PathTracer.render_progressive

    def stale(self, bounces=3):
        return real(self, bounces) if self._accum is None else self._accum

    mp.setattr(PathTracer, "render_progressive", stale)


def _unchanged_render(mp):
    """``render`` hands back its first frame whatever the camera."""
    real, first = PathTracer.render, []

    def stale(self):
        if not first:
            first.append(real(self))
        return first[0]

    mp.setattr(PathTracer, "render", stale)


def _unchanged_refit(mp):
    mp.setattr(PathTracer, "refit_bvh", lambda self, tris: None)


def _half_sample(mp):
    """Each sample's lower half of the image left out."""
    real = pathtracer.pt_sample_frame

    def half(*a, **k):
        img = real(*a, **k).clone()
        img[img.shape[0] // 2:] = 0.0
        return img

    mp.setattr(pathtracer, "pt_sample_frame", half)


def _half_mean(mp):
    """Every other sample of a frame left out, the mean taken over the rest."""
    real = pathtracer.accumulate
    mp.setattr(pathtracer, "accumulate",
               lambda acc, s, n: acc if n % 2 else real(acc, s, n // 2))


def _half_frame(mp):
    real = pathtracer.quantize_rgba8

    def half(rgb):
        out = real(rgb).clone()
        out[out.shape[0] // 2:] = 0
        return out

    mp.setattr(pathtracer, "quantize_rgba8", half)


def _half_cameras(mp):
    real = traverse.trace_tiles_batch

    def half(qn, pos, quat, *a, **k):
        planes = real(qn, pos, quat, *a, **k)
        n = len(pos) // 2
        t, nx, ny, nz, tri = (p.clone() for p in planes)
        t[n:], tri[n:] = 1e30, -1
        return t, nx, ny, nz, tri

    mp.setattr(traverse, "trace_tiles_batch", half)


def _altered_sample(mp):
    """Each sample's radiance 1% off where it is produced."""
    real = pathtracer.pt_sample_frame
    mp.setattr(pathtracer, "pt_sample_frame", lambda *a, **k: real(*a, **k) * 1.01)


def _altered_normals(mp):
    real = pathtracer.trace_tiles

    def altered(*a, **k):
        t, nx, ny, nz, tri = real(*a, **k)
        return t, -nx, ny, nz, tri

    mp.setattr(pathtracer, "trace_tiles", altered)


def _altered_t(mp):
    real = traverse.trace_tiles_batch

    def altered(*a, **k):
        t, nx, ny, nz, tri = real(*a, **k)
        return t * 1.001, nx, ny, nz, tri

    mp.setattr(traverse, "trace_tiles_batch", altered)


def _malformed_frame(mp):
    """Every presented frame in int32 with the right values: counted in
    ``failed``, which alone has to make the run not correct."""
    real = pathtracer.quantize_rgba8
    mp.setattr(pathtracer, "quantize_rgba8", lambda rgb: real(rgb).int())


def _malformed_planes(mp):
    """The normal planes of every batch flattened; t and the triangle intact."""
    real = traverse.trace_tiles_batch

    def flat(*a, **k):
        t, nx, ny, nz, tri = real(*a, **k)
        return t, nx.reshape(-1), ny.reshape(-1), nz.reshape(-1), tri

    mp.setattr(traverse, "trace_tiles_batch", flat)


FAULTS = {
    "dragon.orbit": {"unchanged": _unchanged_render, "half": _half_frame,
                     "altered": _altered_normals, "malformed": _malformed_frame},
    "dragon.progressive3": {"unchanged": _unchanged_progressive, "half": _half_sample,
                            "altered": _altered_sample, "malformed": _malformed_frame},
    "bunny.spp4": {"unchanged": _unchanged_progressive, "half": _half_mean,
                   "altered": _altered_sample, "malformed": _malformed_frame},
    "dragon.deform8": {"unchanged": _unchanged_refit, "half": _half_cameras,
                       "altered": _altered_t, "malformed": _malformed_planes},
}
# the toy orbit moves 10° a frame so that a stale frame shows in a 40-row image
STEP = {"dragon.orbit": {"step_degrees": 10.0}}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_a_planted_fault_comes_out_not_correct(cell, fault, monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    out = run_toy(cell, **STEP.get(cell, {}))
    assert out["correct"] is False, out["checks"]
    if fault == "malformed":  # the kept frames pass; the malformed count fails the run
        assert out["failed"] == out["attempted"] > 0
        assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct_and_the_program_correct(cell):
    assert run_toy(cell, control=True)["correct"] is False
    assert run_toy(cell, seed=2147483999)["correct"] is True


@pytest.mark.cuda
def test_a_card_run_at_toy_size_is_correct_and_its_control_not(cuda_device):
    for cell in CELLS:
        assert run_toy(cell, device=cuda_device, trace=True)["correct"] is True
        assert run_toy(cell, device=cuda_device, control=True)["correct"] is False

