"""A whole run at toy size on the CPU: the result line's keys and order, the
checks last, and the program's toy frames correct against the reference."""

import json
import time
from types import SimpleNamespace

import pytest
from conftest import run_toy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["dragon.orbit", "dragon.progressive3", "bunny.spp4",
                                  "dragon.deform8"])
def test_untraced_line_has_exactly_its_keys_and_is_correct(cell):
    out = run_toy(cell)
    assert list(out) == KEYS + ["checks"]
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert "setup_s" in out["metrics"]
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} and c["value"] <= c["limit"]
               for c in out["checks"].values())


def test_traced_line_adds_breakdown_and_per_layer_metrics():
    out = run_toy("dragon.orbit", trace=True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"host_issue_ms.primary", "build_s"} <= set(out["metrics"])
    assert "setup_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])


class _SlowInput:
    """A traffic whose input takes 20 ms to make and whose frame takes none."""

    def prepare(self, i):
        time.sleep(0.02)

    def frame(self, i):
        return i

    def wait(self, handle):
        pass

    def well_formed(self, handle):
        return True

    def keep(self, i, handle):
        pass


def test_the_traffics_prepare_lies_outside_the_frames_and_the_windows_seconds():
    import harness

    trial = harness.Trial.__new__(harness.Trial)
    trial.traffic, trial.window, trial.failed = _SlowInput(), harness.Window(), 0
    w0 = time.perf_counter()
    w = trial.run_window(0.2)
    wall = time.perf_counter() - w0
    assert w.frames >= 5 and w.prepare_s >= 0.02 * w.frames
    assert max(w.frame_s) < 0.01 and max(w.issue_s) < 0.01
    assert w.seconds == pytest.approx(wall - w.prepare_s, abs=0.01) and w.seconds < 0.05
    run = SimpleNamespace(window=w, rays_per_frame=1000)
    rate = harness.reader_of("mrays_per_s")(run)
    assert rate == pytest.approx(w.frames * 1000 / w.seconds / 1e6)
