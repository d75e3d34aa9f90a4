"""Differential fuzz over random chain topologies in the port (counterpart
of tests/test_fuzz_topologies.py, with its own 8 seeds, chains and
peak-relative bars): on each seeded random chain the port's blockwise
path, which runs the chain's step runner (core/packing.py) block by
block, equals JAX's ``process_array`` on the same config and input, the
port's whole-file fast path equals its blockwise path, and 256-sample
streaming equals 4096-sample blocks."""

import numpy as np
import pytest
import torch

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.fileopts import file_static_overrides

from helpers import bursts
from test_fuzz_topologies import N, random_chain, relative_gap
from test_fuzz_topologies import run as jax_run

FS = 48000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run(cfgs, x, fast, blocksize):
    chain, state, tmap = build_chain(
        cfgs, FS, blocksize, channels_in=x.shape[1],
        static_overrides=file_static_overrides(cfgs), device="cpu")
    _, out = chain.process_array(state, chain.targets(tmap), x, fast=fast)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_random_topology_consistency(seed):
    # The last two seeds may wrap sub-effects in parallel containers.
    rng = np.random.default_rng(1000 + seed)
    cfgs, tol = random_chain(rng, allow_parallel=seed >= 6)
    label = " -> ".join(
        f"{c['type']}({', '.join(f'{k}={v:.3g}' for k, v in c['params'].items())})"
        for c in cfgs)
    x = bursts(N, amp=0.3, seed=seed)

    blockwise = run(cfgs, x, fast=False, blocksize=4096)
    assert np.all(np.isfinite(blockwise)), label
    fast = run(cfgs, x, fast=True, blocksize=4096)
    assert np.all(np.isfinite(fast)), label
    streaming = run(cfgs, x, fast=False, blocksize=256)
    assert np.all(np.isfinite(streaming)), label

    if tol is not None:  # test_fuzz_topologies.chain_tolerance (peak-relative)
        gap = relative_gap(jax_run(cfgs, x, fast=False, blocksize=4096), blockwise)
        assert gap <= tol, f"port-vs-JAX blockwise {gap:.1f} dB > {tol:.1f}: {label}"
        gap = relative_gap(blockwise, fast)
        assert gap <= tol, f"fast-vs-blockwise {gap:.1f} dB > {tol:.1f}: {label}"
        gap = relative_gap(blockwise, streaming)
        assert gap <= tol, f"blocking invariance {gap:.1f} dB > {tol:.1f}: {label}"
