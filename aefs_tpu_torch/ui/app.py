"""Frontend server: stdlib HTTP server for the control-plane UI (port of
aefs_tpu/ui/app.py).

The control plane is the JAX package's static single-page app, served by
path from the repository's ``aefs_tpu/ui/assets/`` (found relative to this
file; never copied, never imported), talking the WebSocket protocol of
``server/backend.py``.  Effect defaults, slider specs and factory presets
are injected from the port's ``core/config.py`` via /config.json, so the UI
and the engine cannot drift apart.

Run: ``python -m aefs_tpu_torch.ui.app`` (``UI_PORT``, default 8050).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

from aefs_tpu_torch.core.config import (
    DEFAULT_PRESETS,
    EFFECT_DEFAULTS,
    STATIC_UI_PARAMS,
    UI_CONTROLS,
)

ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "aefs_tpu", "ui", "assets")


def config_payload():
    return {
        "effect_defaults": EFFECT_DEFAULTS,
        "default_presets": DEFAULT_PRESETS,
        "ui_controls": UI_CONTROLS,
        "static_params": STATIC_UI_PARAMS,
        "ws_port": int(os.environ.get("BACKEND_PORT", 8765)),
    }


class Handler(SimpleHTTPRequestHandler):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, directory=ASSETS_DIR, **kwargs)

    def do_GET(self):
        if self.path.split("?")[0] == "/config.json":
            body = json.dumps(config_payload()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/":
            self.path = "/index.html"
        return super().do_GET()

    def log_message(self, fmt, *args):  # quiet
        pass


def serve(port=8050, blocking=True):
    # Threading: a single stalled client connection must not block
    # index.html, the assets or config.json for every other tab.
    httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    print(f"UI server on http://0.0.0.0:{httpd.server_address[1]}", flush=True)
    if blocking:
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


if __name__ == "__main__":
    serve(int(os.environ.get("UI_PORT", 8050)))
