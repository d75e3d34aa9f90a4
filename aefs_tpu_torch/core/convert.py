"""State trees across packages.

There are no weights: what carries a stream from the JAX package into
this one is the state tree — ring buffers, filter taps, phasors and
smoothed params — with the same keys, nesting, shapes and dtypes in both
packages.  The JAX side hands it over with its leaves converted to numpy
(``jax.tree.map(np.asarray, state)``); int32 counters (``n_abs``, ``row``)
stay int32, and the ring mod's and bitcrusher's uint32 phase accumulators
(``acc``) stay uint32 bit for bit: the port keeps them as ``torch.uint32``
and does their arithmetic in int64 (models/ringmod.py).
"""

from __future__ import annotations

import numpy as np
import torch

from aefs_tpu_torch.models.base import tree_map


def state_from_numpy(tree, device):
    """numpy-leaf state tree -> the port's state on ``device``, dtypes kept."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def state_to_numpy(state):
    """The port's state tree -> the same tree with numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)
