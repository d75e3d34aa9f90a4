"""State trees across packages.

There are no weights: what carries a stream from the JAX package into
this one is the state tree — ring buffers, filter taps, phasors and
smoothed params — with the same keys, nesting, shapes and dtypes in both
packages.  The JAX side hands it over with its leaves converted to numpy
(``jax.tree.map(np.asarray, state)``); int32 counters (``n_abs``, ``row``)
stay int32, and the ring mod's and bitcrusher's uint32 phase accumulators
(``acc``) stay uint32 bit for bit: the port keeps them as ``torch.uint32``
and does their arithmetic in int64 (models/ringmod.py).

The packed form of a state (``core/packing.py``: one flat buffer per
dtype, leaves in JAX's order) crosses too: ``groups_to_numpy`` and
``groups_from_numpy`` carry the groups of JAX's ``PackedRunner.pack_state``
into the port's runner and back.

A checkpoint stores the leaves as a flat list, ``leaf_{i}`` in the order
``jax.tree.flatten`` gives: dict keys sorted, tuples and lists in order.
The port's trees keep insertion order, which differs in most chains, so
``flatten_like_jax`` / ``unflatten_like_jax`` walk them in JAX's order and
a session saved by either package resumes in the other.
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


def groups_from_numpy(groups, device):
    """Packed groups as numpy arrays (JAX's ``PackedRunner.pack_state``
    converted) -> the port's groups on ``device``, dtypes kept."""
    return tuple(torch.tensor(np.asarray(g), device=device) for g in groups)


def groups_to_numpy(groups):
    """The port's packed groups -> numpy arrays, which JAX's runner takes."""
    return tuple(g.detach().cpu().numpy() for g in groups)


def flatten_like_jax(tree):
    """The leaves of a dict/tuple/list tree in ``jax.tree.flatten``'s
    order: dict keys sorted, tuples and lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten_like_jax(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in flatten_like_jax(sub)]
    return [tree]


def unflatten_like_jax(template, leaves):
    """A tree shaped like ``template`` (insertion order kept) whose leaves
    are taken from ``leaves`` in ``flatten_like_jax``'s order."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            filled = {k: fill(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(fill(sub) for sub in t)
        return next(it)

    out = fill(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
