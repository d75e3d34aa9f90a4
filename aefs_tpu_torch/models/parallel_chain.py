"""Parallel effect branches (port of aefs_tpu/models/parallel_chain.py).

A ``parallel`` effect runs N sub-chains on the same input and mixes their
outputs with per-branch gains:

    {"effect_id": "p", "type": "parallel",
     "branches": [[{filter...}, {delay...}], [{reverb...}]],
     "params": {"gain_0": 1.0, "gain_1": 0.5}}

Branch states nest inside its state tree, and every nested live parameter
is lifted into its own param namespace as ``b<branch>_<index>_<name>``
(smoothed with its original spec), numbered by the raw branch-config
index, so the chain's target routing and smoothing apply unchanged:

    update_param("p", "b0_1_delay_ms", 250)

Containers do not nest: a ``parallel`` entry inside a branch is skipped,
like an unknown type.  The ``multiband`` type is a config expansion onto
this container (core/multiband.py).
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, lead


class ParallelChains(EffectModel):
    kind = "parallel"

    def __init__(self, fs, blocksize, channels=2, device="cpu", branches=(),
                 file_mode=False, **config):
        super().__init__(fs, blocksize, channels, device, **config)
        from aefs_tpu_torch.core.fileopts import file_static_overrides
        from aefs_tpu_torch.models import EFFECT_REGISTRY

        self.branches = []  # per branch: [(branch-config index, model), ...]
        params: dict[str, ParamSpec] = {}
        self._initial: dict[str, float] = {}  # branch-config values of lifted params
        for bi, branch in enumerate(branches):
            file_ov = file_static_overrides(branch) if file_mode else {}
            models = []
            for ei, cfg in enumerate(branch):
                cls = EFFECT_REGISTRY.get(cfg.get("type"))
                if cls is None or cls is ParallelChains:  # no nesting
                    continue
                live, static = cls.split_config(dict(cfg.get("params", {})))
                static.update(file_ov.get(cfg.get("effect_id") or f"fx{ei}", {}))
                model = cls(fs, blocksize, channels=channels, device=device, **static)
                # The raw index: skipped entries do not shift the numbering.
                models.append((ei, model))
                for name, spec in model.PARAMS.items():
                    key = f"b{bi}_{ei}_{name}"
                    params[key] = spec
                    if name in live:
                        self._initial[key] = float(live[name])
            self.branches.append(models)
            params[f"gain_{bi}"] = ParamSpec(1.0, 0.0, 2.0, smooth="step", step=0.05)
        self.PARAMS = params  # per instance (the class attribute is empty)

    def initial_params(self, config: dict) -> dict:
        return super().initial_params({**self._initial, **config})

    def init_state(self):
        return {"branches": tuple(tuple(m.init_state() for _, m in models)
                                  for models in self.branches)}

    def map_state(self, f_batched, f_lockstep, st, *rest):
        """Recurse into the branch models, so their LOCKSTEP_STATE keys get
        ``f_lockstep`` one nesting level down too."""
        return {
            "branches": tuple(
                tuple(
                    m.map_state(f_batched, f_lockstep, s,
                                *(r["branches"][bi][si] for r in rest))
                    for si, ((_, m), s) in enumerate(zip(models, bst))
                )
                for bi, (models, bst) in enumerate(zip(self.branches, st["branches"]))
            )
        }

    def _run(self, state, p, x, method):
        new_branches = []
        mix = torch.zeros_like(x)
        for bi, models in enumerate(self.branches):
            buf = x
            new_states = []
            for slot, (ei, model) in enumerate(models):
                sub = {name: p[f"b{bi}_{ei}_{name}"] for name in model.PARAMS}
                st, buf = getattr(model, method)(state["branches"][bi][slot], sub, buf)
                new_states.append(st)
            new_branches.append(tuple(new_states))
            mix = mix + lead(p[f"gain_{bi}"], 2) * buf
        return {"branches": tuple(new_branches)}, torch.clamp(mix, -1.0, 1.0)

    def process(self, state, p, x):
        return self._run(state, p, x, "process")

    def process_file(self, state, p, x):
        return self._run(state, p, x, "process_file")
