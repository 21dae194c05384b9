"""Live viewer server — the interactive loop the reference runs in-browser.

Torch counterpart of ``raytracer_tpu/server/viewer.py``, with the same
endpoints and the same active / idle policy:

* ``GET  /``                → the live shell (public/live.html): a canvas-less
  <img> that polls the latest frame, plus pointer-lock mouse/keyboard capture
  forwarded as JSON input events.
* ``GET  /api/frame.png``   → the most recent rendered frame (in-memory PNG).
* ``POST /api/input``       → {keys:[...], released:[...], dx, dy, fly} —
  applied to the FPSCamera exactly like the reference's DOM handlers.
* ``GET  /api/stats``       → {frame, fps, width, height, scale} for the FPS
  badge (the reference's 1 Hz DOM counter, src/main.js:64-68).

The render loop runs in a background thread (:meth:`ViewerState.start`):
apply queued input → camera update(dt) → ``PathTracer.render_stream`` (or
``render`` when idle) on the card → a copy to pinned host memory → PNG.
:meth:`ViewerState.stop` stops that thread and joins it before it lets go of
anything the thread uses.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import urlparse

import numpy as np
import torch

from ..models.camera import FPSCamera
from ..utils.image import encode_png

__all__ = ["ViewerState", "make_viewer_server", "run_viewer"]

_PUBLIC = Path(__file__).resolve().parents[2] / "public"
VIEWER_PORT = 3000


class _Pull:
    """A frame on its way to the host: on the card, a non-blocking copy into
    pinned host memory and a CUDA event recorded after it on the frame's
    stream; on the CPU, the frame itself."""

    def __init__(self, frame: torch.Tensor, scale: int):
        self.scale = scale
        self.event = None
        if frame.device.type == "cuda":
            self.host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
            self.host.copy_(frame, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(frame.device))
        else:
            self.host = frame

    def wait(self) -> np.ndarray:
        """The frame on the host, once its copy has landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class ViewerState:
    """Shared state between the HTTP handlers and the render thread.

    While the user is ACTIVE (keys held / mouse moving / within
    ``idle_after`` seconds of the last input) frames are rendered
    ``stream_scale``×-downscaled on the card (``PathTracer.render_stream``:
    scale² fewer pixels to copy and encode) and the browser upscales the
    <img>. Once input goes idle, ONE full-resolution frame is rendered and
    published, then the loop parks (no card work, no copies) until the next
    input event.

    Streaming is a two-deep pipeline: each step issues frame i's render and
    its copy to the host, then waits for frame i−1's copy (issued one step
    earlier, so it has landed while the host encoded) and PNG-encodes and
    publishes frame i−1 while the card renders frame i. ``timings`` holds
    the host milliseconds of the last step: ``issue_ms`` (camera, render and
    copy issued), ``wait_ms`` (until the published frame's copy landed) and
    ``encode_ms``."""

    def __init__(self, tracer, camera: FPSCamera | None = None,
                 stream_scale: int = 2, idle_after: float = 0.7):
        self.tracer = tracer
        self.camera = camera or FPSCamera(position=tracer.camera_position)
        self.stream_scale = max(1, int(stream_scale))
        self.idle_after = float(idle_after)
        self.lock = threading.Lock()
        self.frame_png: bytes = encode_png(
            np.zeros((tracer.height, tracer.width, 3), np.uint8)
        )
        self.frame_count = 0
        self.fps = 0.0
        self.scale_now = self.stream_scale
        self.timings = {"issue_ms": 0.0, "wait_ms": 0.0, "encode_ms": 0.0}
        self._pending_mouse = [0.0, 0.0]
        self._last_input = time.monotonic()
        self._idle_published = False
        self._in_flight: _Pull | None = None  # the streamed frame not yet published
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- input ------------------------------------------------------------

    def apply_input(self, msg: dict) -> None:
        with self.lock:
            for code in msg.get("keys", []):
                self.camera.press(str(code))
            for code in msg.get("released", []):
                self.camera.release(str(code))
            self._pending_mouse[0] += float(msg.get("dx", 0.0))
            self._pending_mouse[1] += float(msg.get("dy", 0.0))
            if "fly" in msg:
                self.camera.set_fly(bool(msg["fly"]))
            self._last_input = time.monotonic()
            self._idle_published = False

    # -- render loop --------------------------------------------------------

    def step(self, dt: float) -> bool:
        """One frame: drain input, move the camera, render, encode.

        Returns True if a frame was published (False = parked idle)."""
        t0 = time.perf_counter()
        with self.lock:
            dx, dy = self._pending_mouse
            self._pending_mouse[0] = self._pending_mouse[1] = 0.0
            keys_held = bool(self.camera._keys)
            active = (dx or dy or keys_held
                      or time.monotonic() - self._last_input < self.idle_after)
            if not active and self._idle_published:
                return False
        if dx or dy:
            self.camera.move_mouse(dx, dy)
        self.camera.update(dt)
        p = self.camera.position
        q = self.camera.rotation
        self.tracer.set_camera_position(float(p[0]), float(p[1]), float(p[2]))
        self.tracer.set_camera_quaternion(
            float(q[0]), float(q[1]), float(q[2]), float(q[3])
        )
        scale = self.stream_scale if active else 1
        frame = self.tracer.render_stream(scale) if scale > 1 else self.tracer.render()
        pull = _Pull(frame, scale)
        if active:
            # publish frame i−1 while frame i renders; the first streamed
            # frame has no predecessor and publishes itself
            prev = self._in_flight or pull
            self._in_flight = pull
        else:
            # idle: publish THIS full-res frame, then park — a streamed frame
            # still in flight must not overwrite it
            prev, self._in_flight = pull, None
        t1 = time.perf_counter()
        img = prev.wait()
        t2 = time.perf_counter()
        if prev.scale == 1:
            img = img[..., :3]
        png = encode_png(img, level=1)   # speed > size for streaming
        t3 = time.perf_counter()
        with self.lock:
            self.frame_png = png
            self.frame_count += 1
            self.scale_now = prev.scale
            if not active:
                self._idle_published = True
        self.timings = {"issue_ms": (t1 - t0) * 1e3, "wait_ms": (t2 - t1) * 1e3,
                        "encode_ms": (t3 - t2) * 1e3}
        return True

    def render_loop(self) -> None:
        last = time.perf_counter()
        ema = None
        while not self._stop.is_set():
            now = time.perf_counter()
            dt = min(now - last, 0.1)
            last = now
            if not self.step(dt):
                time.sleep(0.02)   # parked: poll input at 50 Hz, no card work
                continue
            took = time.perf_counter() - now
            ema = took if ema is None else 0.9 * ema + 0.1 * took
            self.fps = 1.0 / max(ema, 1e-6)

    def start(self) -> threading.Thread:
        """Run :meth:`render_loop` in a daemon thread (once)."""
        if self._thread is not None:
            raise RuntimeError("the render thread is already started")
        self._thread = threading.Thread(target=self.render_loop, name="viewer-render",
                                        daemon=True)
        self._thread.start()
        return self._thread

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the render thread and join it; then wait for the last copy in
        flight and drop it. Nothing the thread uses is let go while it runs."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError(f"the render thread did not stop within {timeout} s")
        if self._in_flight is not None:
            self._in_flight.wait()
            self._in_flight = None


def make_viewer_server(state: ViewerState, port: int = VIEWER_PORT,
                       quiet: bool = True) -> ThreadingHTTPServer:
    class _Handler(BaseHTTPRequestHandler):
        def _send(self, code, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802
            path = urlparse(self.path).path
            if path in ("/", "/index.html"):
                shell = _PUBLIC / "live.html"
                self._send(200, shell.read_bytes(), "text/html")
            elif path == "/api/frame.png":
                with state.lock:
                    png = state.frame_png
                self._send(200, png, "image/png")
            elif path == "/api/stats":
                body = json.dumps({
                    "frame": state.frame_count,
                    "fps": round(state.fps, 2),
                    "width": state.tracer.width,
                    "height": state.tracer.height,
                    "scale": state.scale_now,
                }).encode()
                self._send(200, body, "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self) -> None:  # noqa: N802
            path = urlparse(self.path).path
            if path != "/api/input":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                msg = json.loads(self.rfile.read(n) or b"{}")
                state.apply_input(msg)
                self._send(200, b'{"ok":true}', "application/json")
            except (ValueError, KeyError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode(),
                           "application/json")

        def log_message(self, fmt, *args):  # noqa: A003
            if not quiet:
                super().log_message(fmt, *args)

    return ThreadingHTTPServer(("0.0.0.0", port), _Handler)


def run_viewer(tracer, camera: FPSCamera | None = None,
               port: int = VIEWER_PORT, stream_scale: int = 2) -> None:
    """Blocking: start the render thread + HTTP server (apps/viewer.py)."""
    state = ViewerState(tracer, camera, stream_scale=stream_scale)
    state.start()
    srv = make_viewer_server(state, port, quiet=False)
    print(f"[viewer] http://localhost:{port}/  ({tracer.width}x{tracer.height})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        state.stop()
        srv.server_close()
