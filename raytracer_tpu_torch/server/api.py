"""Binary artifact dump API — the reference's Express sidecar, stdlib-only:
a copy of ``raytracer_tpu/server/api.py`` (the sidecar that
``raytracer_tpu_torch.apps.main`` posts ``BVH2.bin`` to). Run it with
``python -m raytracer_tpu_torch.server.api``.

Reference behavior (src/server/api.js): ``POST /api/write`` accepts a raw
octet-stream body up to 200 MB, writes it to ``data/BVH2.bin``, answers JSON
{ok, bytes, path}; CORS is restricted to the dev origin; listens on :3000.
This port adds ``POST /api/write?name=...`` (sanitized filename within the
data dir) and ``GET /api/read?name=...`` so artifacts can round-trip, plus
``GET /health``.
"""

from __future__ import annotations

import json
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

__all__ = ["make_server", "serve_forever", "MAX_BYTES", "PORT", "ALLOWED_ORIGIN"]

MAX_BYTES = 200 * 1024 * 1024         # api.js:20 ("200mb")
PORT = 3000                            # api.js:44
ALLOWED_ORIGIN = "http://localhost:5173"  # api.js:9-13
DEFAULT_NAME = "BVH2.bin"

# at least one alphanumeric required: bare-dot names like ".." stay inside
# data/ (no separators) but crash write_bytes on a directory (ADVICE r1 #3)
_NAME_RE = re.compile(r"^(?=.*[A-Za-z0-9])[A-Za-z0-9._-]+$")


class _Handler(BaseHTTPRequestHandler):
    data_dir: Path = Path("data")
    quiet: bool = False

    def _cors(self) -> None:
        self.send_header("Access-Control-Allow-Origin", ALLOWED_ORIGIN)
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "Content-Type")

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self._cors()
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _resolve_name(self, query: dict) -> str | None:
        name = query.get("name", [DEFAULT_NAME])[0]
        return name if _NAME_RE.match(name) else None

    def do_OPTIONS(self) -> None:  # noqa: N802
        self.send_response(204)
        self._cors()
        self.end_headers()

    def do_POST(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        if url.path != "/api/write":
            self._json(404, {"error": "not found"})
            return
        name = self._resolve_name(parse_qs(url.query))
        if name is None:
            self._json(400, {"error": "bad name"})
            return
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            self._json(400, {"error": "empty body"})
            return
        if length > MAX_BYTES:
            self._json(413, {"error": "payload too large"})
            return
        data = self.rfile.read(length)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        out = self.data_dir / name
        out.write_bytes(data)
        if not self.quiet:
            print(f"[api] wrote {len(data)} bytes -> {out}")
        self._json(200, {"ok": True, "bytes": len(data), "path": str(out)})

    def do_GET(self) -> None:  # noqa: N802
        url = urlparse(self.path)
        if url.path == "/health":
            self._json(200, {"ok": True})
            return
        if url.path != "/api/read":
            self._json(404, {"error": "not found"})
            return
        name = self._resolve_name(parse_qs(url.query))
        if name is None:
            self._json(400, {"error": "bad name"})
            return
        path = self.data_dir / name
        if not path.exists():
            self._json(404, {"error": "no such artifact"})
            return
        data = path.read_bytes()
        self.send_response(200)
        self._cors()
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # silence default stderr spam
        if not self.quiet:
            super().log_message(fmt, *args)


def make_server(port: int = PORT, data_dir: str | Path = "data", quiet: bool = False):
    handler = type("Handler", (_Handler,), {"data_dir": Path(data_dir), "quiet": quiet})
    return ThreadingHTTPServer(("127.0.0.1", port), handler)


def serve_forever(port: int = PORT, data_dir: str | Path = "data") -> None:
    srv = make_server(port, data_dir)
    print(f"[api] listening on :{srv.server_address[1]}, data dir {data_dir}")
    srv.serve_forever()


if __name__ == "__main__":
    serve_forever()
