"""Runtime device selection (port of aefs_tpu/utils/platform.py).

``AEFS_PLATFORM`` picks the device for server and CLI entry points, as it
picks the JAX platform in the reference:

    AEFS_PLATFORM=cpu    — the host (development, tests)
    AEFS_PLATFORM=cuda   — the card (the default)

There is no fallback: asking for the card where there is none raises.
"""

from __future__ import annotations

import contextlib
import os

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is visible."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available "
            "(pass device='cpu' to run on the host)")
    return device


def select_device(default: str | None = None) -> torch.device:
    """The device named by ``AEFS_PLATFORM``, else ``default``, else the
    card."""
    return require_device(os.environ.get("AEFS_PLATFORM") or default or "cuda")


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` without an index
    is the current card)."""
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return norm(a) == norm(b)


def device_scope(device):
    """A context with ``device`` current when it is a card (a no-op for
    the host).  Every entry point runs its card work under it: eager ops
    issued for one card while another, still unused, is current may fault
    on a machine of several cards."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)
