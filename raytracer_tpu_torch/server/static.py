"""Static file server — the reference's second Express sidecar, fixed (stdlib
only): a copy of ``raytracer_tpu/server/static.py``.

The reference's server.js is vestigial/broken (it resolves ``public/``
relative to ``src/`` which doesn't exist — SURVEY.md §2 static-server row).
This one actually serves: ``/`` → the viewer index, ``/debug`` → the debug
page, plus anything under the web root (rendered frames, BVH JSON dumps).
Default port 3000 matches server.js:5; pass another when running alongside
the API server.
"""

from __future__ import annotations

import functools
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

__all__ = ["make_server", "serve_forever", "PORT"]

PORT = 3000  # server.js:5


class _Handler(SimpleHTTPRequestHandler):
    def do_GET(self):  # noqa: N802
        if self.path in ("/", ""):
            self.path = "/index.html"
        elif self.path == "/debug":
            self.path = "/debug.html"
        return super().do_GET()

    def log_message(self, fmt, *args):
        pass


def make_server(port: int = PORT, root: str | Path = "public"):
    handler = functools.partial(_Handler, directory=str(root))
    return ThreadingHTTPServer(("127.0.0.1", port), handler)


def serve_forever(port: int = PORT, root: str | Path = "public") -> None:
    srv = make_server(port, root)
    print(f"[static] serving {root} on :{srv.server_address[1]}")
    srv.serve_forever()


if __name__ == "__main__":
    serve_forever()
