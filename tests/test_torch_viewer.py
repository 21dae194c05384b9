"""The PyTorch port's live viewer and static server on the CPU: the
assertions of ``tests/test_viewer_apps.py`` (endpoints, adaptive streaming)
and ``tests/test_server.py::test_static_routes`` on the port, the PNGs of the
JAX viewer for the same input sequence (byte-equal), the idle full-resolution
frame against ``PathTracer.render()``, and ``stop()`` while the render loop
runs (the render thread raises nothing and is joined).
"""

import json
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest

from raytracer_tpu.models.camera import FPSCamera as JaxFPSCamera
from raytracer_tpu.pathtracer import PathTracer as JaxPathTracer
from raytracer_tpu.server.viewer import ViewerState as JaxViewerState
from raytracer_tpu.utils import procgen as jax_procgen
from raytracer_tpu_torch import FPSCamera, PathTracer
from raytracer_tpu_torch.apps import viewer as viewer_app
from raytracer_tpu_torch.server import static as static_server
from raytracer_tpu_torch.server.viewer import ViewerState, make_viewer_server
from raytracer_tpu_torch.utils import procgen
from torch_parity import decode_png

START = [0.0, 0.0, 2.5]


def port_state(**kwargs) -> ViewerState:
    tracer = PathTracer(width=64, height=64, device="cpu")
    tracer.build_bvh(procgen.make_icosphere(2))
    return ViewerState(tracer, FPSCamera(position=START), **kwargs)


@pytest.fixture()
def viewer():
    state = port_state()
    srv = make_viewer_server(state, port=0)   # ephemeral port
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield state, srv
    srv.shutdown()
    srv.server_close()


def _get(srv, path):
    port = srv.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return r.read()


def _post(srv, path, payload):
    port = srv.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode()
    )
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def png_size(data):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", data[16:24])


def test_viewer_endpoints(viewer):
    state, srv = viewer

    state.step(1 / 60)
    png = _get(srv, "/api/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"

    stats = json.loads(_get(srv, "/api/stats"))
    assert stats["frame"] == 1 and stats["width"] == 64

    assert b"pointerLockElement" in _get(srv, "/")

    p0 = state.camera.position.copy()
    assert _post(srv, "/api/input", {"keys": ["KeyW"], "dx": 10, "dy": 0})["ok"]
    state.step(0.1)
    p1 = state.camera.position.copy()
    assert np.linalg.norm(p1 - p0) > 1e-3          # moved forward
    assert state.camera.rotation[1] != 0.0          # yawed from the mouse dx

    # the streaming loop is pipelined: the moved frame publishes one step later
    state.step(0.1)
    assert _get(srv, "/api/frame.png") != png

    assert _post(srv, "/api/input", {"released": ["KeyW"]})["ok"]
    state.step(0.1)
    p2 = state.camera.position.copy()
    state.step(0.1)
    assert np.allclose(state.camera.position, p2)


def test_viewer_adaptive_streaming(viewer):
    """Active input streams downscaled frames; idle publishes ONE full-res
    frame then parks the loop (no renders until the next input event)."""
    state, srv = viewer

    _post(srv, "/api/input", {"dx": 5.0})
    assert state.step(1 / 30) is True
    assert png_size(_get(srv, "/api/frame.png")) == (64 // state.stream_scale,
                                                     64 // state.stream_scale)
    assert state.scale_now == state.stream_scale

    state._last_input = 0.0
    assert state.step(1 / 30) is True
    assert png_size(_get(srv, "/api/frame.png")) == (64, 64)
    assert state.scale_now == 1
    n = state.frame_count
    assert state.step(1 / 30) is False          # parked
    assert state.frame_count == n

    _post(srv, "/api/input", {"dx": 1.0})
    assert state.step(1 / 30) is True


# (input message or None, dt) pairs, then the idle step
SEQUENCE = [({"keys": ["KeyW"], "dx": 10.0, "dy": -4.0}, 0.1), (None, 0.05),
            ({"released": ["KeyW"], "dx": -3.0}, 0.1), (None, 0.02)]


def drive(state) -> list[bytes]:
    """Run SEQUENCE, then one idle step → every PNG the viewer published.
    The sequence stays active however slowly the host renders; then idle."""
    pngs = []
    state.idle_after = 1e9
    for msg, dt in SEQUENCE:
        if msg is not None:
            state.apply_input(msg)
        assert state.step(dt) is True
        pngs.append(state.frame_png)
    state.idle_after = 0.0
    assert state.step(0.03) is True
    pngs.append(state.frame_png)
    return pngs


def test_viewer_pngs_equal_the_jax_viewer():
    """The same input sequence through the JAX viewer and the port's: every
    published PNG (streamed at scale 2, then the idle full frame) is the
    same file."""
    tracer = JaxPathTracer(width=64, height=64)
    tracer.build_bvh(jax_procgen.make_icosphere(2))
    ref = JaxViewerState(tracer, JaxFPSCamera(position=START))
    try:
        want = drive(ref)
    finally:
        ref.stop()
    got = drive(port_state())
    assert [png_size(p) for p in got] == [(32, 32)] * len(SEQUENCE) + [(64, 64)]
    assert got == want


def test_idle_png_is_render_at_the_same_camera():
    """The idle full-resolution PNG decodes to the port's render() bytes at
    the camera the same input sequence gives a fresh FPSCamera."""
    state = port_state()
    png = drive(state)[-1]
    cam = FPSCamera(position=START)
    for msg, dt in SEQUENCE + [(None, 0.03)]:
        for code in (msg or {}).get("keys", []):
            cam.press(code)
        for code in (msg or {}).get("released", []):
            cam.release(code)
        if msg and (msg.get("dx") or msg.get("dy")):
            cam.move_mouse(msg.get("dx", 0.0), msg.get("dy", 0.0))
        cam.update(dt)
    np.testing.assert_array_equal(cam.position, state.camera.position)
    tracer = PathTracer(width=64, height=64, device="cpu")
    tracer.build_bvh(procgen.make_icosphere(2))
    p, q = cam.position, cam.rotation
    tracer.set_camera_position(float(p[0]), float(p[1]), float(p[2]))
    tracer.set_camera_quaternion(float(q[0]), float(q[1]), float(q[2]), float(q[3]))
    np.testing.assert_array_equal(decode_png(png), tracer.render().numpy()[..., :3])


def test_stop_while_render_loop_runs():
    """stop() during a running render loop: the thread ends, is joined, and
    raises nothing; the state publishes no frame after stop() returns."""
    errors = []
    old_hook = threading.excepthook
    threading.excepthook = errors.append
    try:
        state = port_state(idle_after=1e9)   # active for good: a frame each step
        thread = state.start()
        deadline = time.monotonic() + 30
        while state.frame_count < 3 and time.monotonic() < deadline:
            state.apply_input({"dx": 1.0})
            time.sleep(0.01)
        assert state.frame_count >= 3, "the render loop published no frames"
        state.stop()
        assert not thread.is_alive()
        n = state.frame_count
        time.sleep(0.05)
        assert state.frame_count == n
        with pytest.raises(RuntimeError):
            state.start()
    finally:
        threading.excepthook = old_hook
    assert errors == [], f"the render thread raised: {errors}"


def test_static_routes(tmp_path):
    (tmp_path / "index.html").write_text("<html>viewer</html>")
    (tmp_path / "debug.html").write_text("<html>debug</html>")
    srv = static_server.make_server(port=0, root=tmp_path)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        port = srv.server_address[1]
        assert b"viewer" in urllib.request.urlopen(f"http://127.0.0.1:{port}/").read()
        assert b"debug" in urllib.request.urlopen(f"http://127.0.0.1:{port}/debug").read()
    finally:
        srv.shutdown()
        srv.server_close()


def test_viewer_app_builds_and_serves(monkeypatch):
    """apps.viewer with --device cpu: --builder auto resolves to the CPU's
    fast_build_options (the Morton LBVH at K = 1), the scene is built at the
    requested size, and run_viewer gets the port and stream scale."""
    calls = []
    monkeypatch.setattr(viewer_app, "run_viewer",
                        lambda tracer, camera, port, stream_scale: calls.append(
                            (tracer, camera, port, stream_scale)))
    assert viewer_app.main(["--procgen", "cornell", "--width", "48", "--height", "32",
                            "--port", "0", "--stream-scale", "4", "--device", "cpu"]) == 0
    (tracer, camera, port, scale), = calls
    assert (tracer.builder, tracer.leaf_size, tracer.device.type) == ("lbvh", 1, "cpu")
    assert (tracer.width, tracer.height, port, scale) == (48, 32, 0, 4)
    assert tracer.render().shape == (32, 48, 4)
    np.testing.assert_array_equal(camera.position, [0.0, 0.0, 2.5])
