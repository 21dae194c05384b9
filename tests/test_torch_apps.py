"""The port's headless apps (``python -m raytracer_tpu_torch.apps.main`` and
``apps.debug``, here with ``--device cpu``) against the JAX package's
``apps/main.py`` and ``apps/debug.py`` on the same arguments, and the port's
artifact API server (``raytracer_tpu_torch/server/api.py``) on the cases of
``tests/test_server.py``.

Tolerances: PNG and JSON files byte-equal to the JAX apps'; the BVH2.bin the
server receives byte-equal to ``bvh2_artifact()``.
"""

import argparse
import importlib.util
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from raytracer_tpu_torch import PathTracer
from raytracer_tpu_torch.apps import debug as app_debug
from raytracer_tpu_torch.apps import main as app_main
from raytracer_tpu_torch.server import api as api_server

REPO = Path(__file__).resolve().parents[1]
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def jax_app(name: str):
    """The JAX package's ``apps/<name>.py``, imported from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_app_{name}", REPO / "apps" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_app_main_png_matches_the_jax_app(tmp_path):
    """The arguments of tests/test_viewer_apps.py (an unreachable API: the
    dump is skipped gracefully): the port's PNG is the JAX app's, byte for
    byte."""
    args = ["--scene", "icosphere", "--frames", "2", "--width", "64", "--height", "64",
            "--api", "http://127.0.0.1:1"]
    assert app_main.main([*args, "--out", str(tmp_path / "port.png"), "--device", "cpu"]) == 0
    assert jax_app("main").main([*args, "--out", str(tmp_path / "jax.png")]) == 0
    port = (tmp_path / "port.png").read_bytes()
    assert port[:8] == PNG_MAGIC and len(port) > 500
    assert port == (tmp_path / "jax.png").read_bytes()


def test_app_debug_matches_the_jax_app(tmp_path):
    """apps.debug at 64×64: the overlay PNG and the BVH JSON are the JAX
    app's, byte for byte."""
    for name, app, extra in (("port", app_debug, ["--device", "cpu"]),
                             ("jax", jax_app("debug"), [])):
        assert app.main(["--width", "64", "--height", "64", "--out", str(tmp_path / f"{name}.png"),
                         "--json", str(tmp_path / f"{name}.json"), *extra]) == 0
    assert (tmp_path / "port.png").read_bytes()[:8] == PNG_MAGIC
    for ext in ("png", "json"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()


@pytest.fixture()
def api(tmp_path):
    srv = api_server.make_server(port=0, data_dir=tmp_path, quiet=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv, tmp_path
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(port, path, data):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/octet-stream"})
    return urllib.request.urlopen(req, timeout=10)


def test_api_write_artifact_roundtrip(api):
    srv, data_dir = api
    port = srv.server_address[1]
    payload = np.arange(100, dtype=np.uint32).tobytes()
    resp = _post(port, "/api/write", payload)
    assert resp.status == 200
    assert (data_dir / "BVH2.bin").read_bytes() == payload
    back = urllib.request.urlopen(f"http://127.0.0.1:{port}/api/read?name=BVH2.bin", timeout=10)
    assert back.read() == payload


def test_api_write_named_and_traversal_rejected(api):
    srv, data_dir = api
    port = srv.server_address[1]
    _post(port, "/api/write?name=BVH4_wide.bin", b"\x01\x02\x03\x04")
    assert (data_dir / "BVH4_wide.bin").exists()
    for bad in ("..%2Fevil", ".."):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, f"/api/write?name={bad}", b"x")
        assert e.value.code == 400


def test_api_unknown_route_and_missing_artifact_404(api):
    srv, _ = api
    port = srv.server_address[1]
    for path in ("/api/nope", "/api/read?name=absent.bin"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10)
        assert e.value.code == 404


def test_api_empty_body_rejected(api):
    srv, _ = api
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv.server_address[1], "/api/write", b"")
    assert e.value.code == 400


def test_api_cors_headers(api):
    srv, _ = api
    resp = urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/health", timeout=10)
    assert resp.headers["Access-Control-Allow-Origin"] == api_server.ALLOWED_ORIGIN


def test_app_main_dumps_into_the_port_api(api, tmp_path):
    """apps.main posts BVH2.bin to a live port API server: the file equals
    bvh2_artifact() of a tracer built on the app's scene; a packed-cluster
    tree is not dumped."""
    srv, data_dir = api
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    args = ["--scene", "cornell", "--frames", "1", "--width", "32", "--height", "24",
            "--api", url, "--device", "cpu", "--out", str(tmp_path / "frame.png")]
    assert app_main.main([*args, "--builder", "lbvh"]) == 0
    ref = PathTracer(32, 24, device="cpu")
    ref.build_bvh(app_main._load_scene(argparse.Namespace(glb=None, scene="cornell")).triangles)
    dumped = (data_dir / "BVH2.bin").read_bytes()
    assert dumped == ref.bvh2_artifact().tobytes() and len(dumped) > 4
    (data_dir / "BVH2.bin").unlink()
    assert app_main.main([*args, "--builder", "sah", "--leaf", "8"]) == 0
    assert not (data_dir / "BVH2.bin").exists()
