"""Launcher: spawn the port's WebSocket backend and UI server, monitor both,
tear them down together (port of the repository's run.py, after reference
run.py:21-65).

    python -m aefs_tpu_torch.run [--backend-port 8765] [--ui-port 8050]

The children are ``python -m aefs_tpu_torch.server.backend`` (on the device
``AEFS_PLATFORM`` names, else the card) and ``python -m
aefs_tpu_torch.ui.app``; ``PORT``, ``BACKEND_PORT``, ``UI_PORT`` and
``AEFS_PLATFORM`` reach them through the environment.  Nothing is
installed: without ``sounddevice`` the launcher says mic mode is off, and
file mode works.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import signal
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def check_dependencies():
    """Mic capture needs ``sounddevice``, which server and cloud images
    omit; the backend then serves file mode only (engine.py's server mode)."""
    try:
        import sounddevice  # noqa: F401
    except Exception:  # absent, or present without a PortAudio library
        print("sounddevice unavailable: mic mode disabled, file mode works", flush=True)


def run_services(backend_port: int, ui_port: int):
    check_dependencies()
    env = dict(os.environ, PORT=str(backend_port), BACKEND_PORT=str(backend_port))
    procs = {}

    # SIGTERM must tear the children down too (KeyboardInterrupt covers only
    # Ctrl-C): killing the launcher must not leak a backend holding the card.
    def _terminate(_sig, _frame):
        # One-shot: once teardown has begun, a second SIGTERM must not
        # interrupt the child cleanup below.
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _terminate)
    try:
        procs["backend"] = subprocess.Popen(
            [sys.executable, "-m", "aefs_tpu_torch.server.backend"], env=env, cwd=ROOT)
        print(f"Starting backend on port {backend_port} (pid {procs['backend'].pid})...",
              flush=True)
        time.sleep(1)
        procs["ui"] = subprocess.Popen(
            [sys.executable, "-m", "aefs_tpu_torch.ui.app"], env=dict(env, UI_PORT=str(ui_port)),
            cwd=ROOT)
        print(f"Starting UI on port {ui_port} (pid {procs['ui'].pid})...", flush=True)
        print(f"Open http://localhost:{ui_port}", flush=True)

        while True:
            time.sleep(1)
            for name, p in procs.items():
                if p.poll() is not None:
                    print(f"Service '{name}' exited ({p.returncode}); shutting down", flush=True)
                    return
    except KeyboardInterrupt:
        print("\nShutting down...", flush=True)
    finally:
        # Mask BOTH signals before touching the children: a Ctrl-C teardown
        # interrupted by SIGTERM (or a second Ctrl-C) would otherwise abandon
        # the cleanup midway and leak the backend.
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 5
        for p in procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend-port", type=int, default=int(os.environ.get("PORT", 8765)))
    ap.add_argument("--ui-port", type=int, default=int(os.environ.get("UI_PORT", 8050)))
    args = ap.parse_args(argv)
    run_services(args.backend_port, args.ui_port)


if __name__ == "__main__":
    main()
