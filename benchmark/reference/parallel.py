"""Parallel container: each branch is a chain run on the same input; the
branches' outputs are summed with their gains and clipped to [-1, 1]."""

import numpy as np

DEFAULTS = {}


def apply_branches(x, cfg, fs, run_chain):
    gains = cfg.get("params", {})
    out = 0.0
    for i, branch in enumerate(cfg["branches"]):
        out = out + gains.get(f"gain_{i}", 1.0) * run_chain(x, branch, fs)
    return np.clip(out, -1.0, 1.0)
