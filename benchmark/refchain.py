"""Runs a chain config through the plain reference (``reference/``), one
module per effect type, found by the type's name.

A control (``precision``) puts the reference at a lower precision:

- ``"bfloat16"`` (any torch dtype's name): every effect's output, and
  the input, rounded to that dtype;
- ``"float32:filter"`` (a NumPy dtype's name, a colon and effect types,
  comma-separated): those effect types computed in that dtype from an
  input held at it, everything else in float64.  A module computes in its
  input's dtype where it reads one (``filter``'s biquads do).
"""

from __future__ import annotations

import importlib

import numpy as np


def effect_module(kind: str):
    return importlib.import_module(f"benchmark.reference.{kind}")


def _rounder(precision):
    """The rounding applied after every effect; None keeps float64."""
    if precision is None or ":" in precision:
        return lambda x: x
    import torch

    dt = getattr(torch, precision)
    return lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dt).to(torch.float64).numpy()


def _computed_in(precision):
    """{effect type: dtype} that the control computes at a lower precision."""
    if precision is None or ":" not in precision:
        return {}
    dtype, kinds = precision.split(":", 1)
    return {k: np.dtype(dtype) for k in kinds.split(",")}


def run_chain(x, chain_config, fs, precision=None):
    """x (..., 2, N) float64 through every effect of ``chain_config``."""
    rnd = _rounder(precision)
    lower = _computed_in(precision)

    def run(sig, effects, fs):
        for cfg in effects:
            kind = cfg["type"]
            if kind == "parallel":
                sig = effect_module("parallel").apply_branches(sig, cfg, fs, run)
            else:
                mod = effect_module(kind)
                p = {**mod.DEFAULTS, **cfg.get("params", {})}
                if kind in lower:
                    sig = np.asarray(mod.apply(sig.astype(lower[kind]), p, fs), np.float64)
                else:
                    sig = mod.apply(sig, p, fs)
            sig = rnd(sig)
        return sig

    return run(rnd(np.asarray(x, np.float64)), chain_config, fs)


def render_mono(mono, chain_config, fs, precision=None):
    """(..., N) mono in, fanned to two channels -> (..., 2, N) out."""
    mono = np.asarray(mono, np.float64)
    x = np.broadcast_to(mono[..., None, :], mono.shape[:-1] + (2, mono.shape[-1]))
    return run_chain(x, chain_config, fs, precision)
