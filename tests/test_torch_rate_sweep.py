"""The non-48 kHz parity sweep (tests/test_rate_sweep.py) in the PyTorch
port, on its CPU path, with the JAX file's own cases, signals, lengths and
bars (imported from it):

- one oracle-parity case per fs-sensitive effect at 44.1 and 96 kHz
  against its float64 oracle, <= -80 dBFS, and against the JAX package's
  render of the same case, <= -90 dBFS, but for two stated exceptions
  (``JAX_FAULTS``), where JAX's own render misses the oracle by more and
  the port is held to the oracle at -90 dBFS instead;
- the convolution reverb with ``synthetic_ir`` at both rates, the same two
  bars;
- the five-effect chain's 256-sample blocks against its 2048-sample
  superblocks (blocking invariance), <= -80 dBFS, and each against JAX's.
"""

import numpy as np
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu.models import synthetic_ir as jax_synthetic_ir
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.models import synthetic_ir

from helpers import noise
from oracles import OracleConvReverb, err_dbfs, run_oracle_blocks
from test_rate_sweep import CASES, FIVE_FX, FRAMES, N, RATES
from test_rate_sweep import run_chain as jax_run_chain

JAX_BAR = -90  # PERF.md §2: the port against the JAX package
ORACLE_BAR = -80  # the JAX file's bar against the float64 oracles
# Stated exceptions, faults of the reference: JAX's float32 coefficients
# put its own render -87.2 dBFS from the float64 oracle for the gate at
# 44.1 kHz and -84.0 for the shelf biquad at 96 kHz (its near-unit poles),
# where the port, which evaluates them in float64, is at -108.1 and
# -100.4.  There the port is held to the oracle at the JAX bar, and JAX
# must be the further of the two from it.
JAX_FAULTS = {("gate", 44100), ("filter", 96000)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run_chain(cfg, x, fs, blocksize=N, static_overrides=None):
    """test_rate_sweep.run_chain in the port: the block step over the
    whole signal (``process_array``)."""
    chain, state, tmap = build_chain([cfg], fs, blocksize, channels_in=x.shape[1],
                                     channels_out=2, device="cpu",
                                     static_overrides=static_overrides)
    _, out = chain.process_array(state, chain.targets(tmap), x)
    return out


@pytest.mark.parametrize("fs", RATES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_effect_parity_at_rate(case, fs):
    etype, params, oracle_cls, mk = case
    x = mk(fs)
    cfg = {"effect_id": "e", "type": etype, "params": params}
    got = run_chain(cfg, x, fs)
    # The oracle takes the float32 values the effect receives
    # (test_rate_sweep.py's rule).
    okw = {k: (float(np.float32(v)) if isinstance(v, float) else v)
           for k, v in params.items()}
    if etype == "spectral":
        okw["hop"] = N
    ref = run_oracle_blocks(oracle_cls(fs, **okw), x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= ORACLE_BAR, (etype, fs, err_dbfs(got, ref))
    jax_out = jax_run_chain(cfg, x, fs)
    if (etype, fs) in JAX_FAULTS:
        assert err_dbfs(got, ref) <= JAX_BAR < err_dbfs(jax_out, ref), (
            etype, fs, err_dbfs(got, ref), err_dbfs(jax_out, ref))
    else:
        assert err_dbfs(got, jax_out) <= JAX_BAR, (etype, fs, err_dbfs(got, jax_out))


@pytest.mark.parametrize("fs", RATES)
def test_convreverb_parity_at_rate(fs):
    ir = synthetic_ir(fs, 0.25, channels=2)
    np.testing.assert_array_equal(ir, jax_synthetic_ir(fs, 0.25, channels=2))
    x = noise(FRAMES, amp=0.2)
    cfg = {"effect_id": "c", "type": "convreverb", "params": {"mix_dry": 0.7, "mix_wet": 0.4}}
    overrides = {"convreverb": {"ir": ir}}
    got = run_chain(cfg, x, fs, static_overrides=overrides)
    ref = run_oracle_blocks(OracleConvReverb(ir, mix_dry=0.7, mix_wet=0.4),
                            x.astype(np.float64), N)
    assert err_dbfs(got, ref) <= ORACLE_BAR, err_dbfs(got, ref)
    jax_out = jax_run_chain(cfg, x, fs, static_overrides=overrides)
    assert err_dbfs(got, jax_out) <= JAX_BAR, err_dbfs(got, jax_out)


@pytest.mark.parametrize("fs", RATES)
def test_blocking_invariance_at_rate(fs):
    """256-sample blocks against 2048-sample superblocks at 44.1 and 96 kHz
    (every feedback solve and scan whose lag re-derives from fs), and the
    256-sample render against JAX's."""
    x = noise(8 * 2048, amp=0.25)
    outs = {}
    for bs in (256, 2048):
        chain, state, tmap = build_chain(FIVE_FX, fs, bs, channels_in=2, device="cpu",
                                         static_overrides={"delay": {"min_delay_ms": 375.0}})
        _, outs[bs] = chain.process_array(state, chain.targets(tmap), x)
    assert err_dbfs(outs[256], outs[2048]) <= ORACLE_BAR, (fs, err_dbfs(outs[256], outs[2048]))
    jchain, jstate, jtmap = jax_build(FIVE_FX, fs, 256, channels_in=2,
                                      static_overrides={"delay": {"min_delay_ms": 375.0}})
    _, jax_out = jchain.process_array(jstate, jchain.targets(jtmap), x)
    assert err_dbfs(outs[256], jax_out) <= JAX_BAR, (fs, err_dbfs(outs[256], jax_out))
