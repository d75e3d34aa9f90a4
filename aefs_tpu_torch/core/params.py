"""Functional parameter smoothing (port of aefs_tpu/core/params.py).

The smoothed current value of every live parameter is carried in the
chain state as a 0-dim float32 tensor and stepped toward its target once
per block — the reference's ``SmoothParam.step_towards`` (core.py:72-77)
as a pure function.  Every step is elementwise, so a pool's (S,) currents
and targets smooth slot by slot in the same ops.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Static description of one live parameter.

    smooth:
      "step"    — clamped linear step of ``step`` per block
      "step_ms" — step of ``step`` *samples* converted to ms via the sample
                  rate (the reference's ``_delay_step_ms``, delay.py:78)
      "mult"    — step proportional to the current value (the filter
                  cutoff's "log-ish feel", filter.py:103)
      "instant" — plain attribute set, no smoothing
    """

    default: float
    lo: float
    hi: float
    smooth: str = "instant"
    step: float = 0.0

    def max_step(self, fs: float, current):
        if self.smooth == "step":
            return self.step
        if self.smooth == "step_ms":
            return 1000.0 * self.step / fs
        if self.smooth == "mult":
            return current * self.step
        raise ValueError(self.smooth)

    def clamp(self, value: float) -> float:
        return min(max(float(value), self.lo), self.hi)


def lead(v, k: int = 1):
    """``v`` with ``k`` trailing unit axes when it carries slot dims (so an
    (S,) param meets an (S, ..., N) signal); a 0-dim ``v`` unchanged."""
    return v.reshape(v.shape + (1,) * k) if v.dim() else v


def smooth_step(current, target, max_step):
    """One clamped step of ``current`` toward ``target``."""
    delta = torch.clamp(target - current, -max_step, max_step)
    return current + delta


def smooth_all(specs: dict, current: dict, targets: dict, fs: float) -> dict:
    """Advance every parameter one block toward its target."""
    out = {}
    for name, spec in specs.items():
        cur, tgt = current[name], targets[name]
        if spec.smooth == "instant":
            out[name] = tgt
        else:
            out[name] = smooth_step(cur, tgt, spec.max_step(fs, cur))
    return out


def init_params(specs: dict, config: dict, device="cpu") -> dict:
    """Initial current==target values: defaults overridden by the
    chain-config params dict, clamped to spec bounds."""
    return {
        name: torch.tensor(spec.clamp(config.get(name, spec.default)),
                           dtype=torch.float32, device=device)
        for name, spec in specs.items()
    }
