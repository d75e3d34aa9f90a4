"""The biquad's block step (ops/kernels/biquad.py) on the CPU: the wrapper
takes its plain version there, which is the effect's coefficients and
float64 scan bit for bit; ``BiquadFilter.process`` routes only blocks
shorter than 1,024 samples to it; the wrapper's shape and dtype checks.
Kernel K5 itself is held to the plain version on the card
(tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

from aefs_tpu_torch.models import biquad as biquad_mod
from aefs_tpu_torch.models.biquad import BiquadFilter, coefficients
from aefs_tpu_torch.ops import scan
from aefs_tpu_torch.ops.kernels.biquad import biquad_step

FS = 48000
TYPES = range(7)


def _params(rng, ftype, slots):
    """Params of ``ftype`` (None: a type per slot), cutoffs 20 Hz to 20 kHz
    (the top meets the 0.45 fs clamp), q 0.1 to 10, gain -24 to +24 dB;
    0-dim without slot dims."""
    shape = (slots,) if slots else ()
    types = np.arange(slots) % 7 if ftype is None else np.full(shape, ftype)
    vals = {"filter_type": types,
            "cutoff_hz": np.exp(rng.uniform(np.log(20.0), np.log(20000.0), shape)),
            "q": rng.uniform(0.1, 10.0, shape), "gain_db": rng.uniform(-24.0, 24.0, shape)}
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in vals.items()}


def _run(step, p, slots, n, blocks, seed):
    """``blocks`` blocks of noise (two channels) through ``step`` from a
    noise state; returns the outputs and the final df1."""
    rng = np.random.default_rng(seed)
    lead = (slots,) if slots else ()
    df1 = torch.tensor((0.2 * rng.standard_normal(lead + (2, 4))).astype(np.float32))
    ys = []
    for _ in range(blocks):
        x = torch.tensor((0.3 * rng.standard_normal(lead + (2, n))).astype(np.float32))
        st, y = step({"df1": df1}, p, x)
        df1 = st["df1"]
        ys.append(y)
    return ys, df1


def _reference(st, p, x):
    """The streaming block's arithmetic written out: the coefficients, then
    the float64 companion scan (``ops/scan.py:biquad_block``)."""
    y, df1 = scan.biquad_block(x, *coefficients(p, FS), st["df1"])
    return {"df1": df1}, y


def _assert_same(got, want):
    for a, b in zip(got[0], want[0]):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    assert got[1].shape == want[1].shape and torch.equal(got[1], want[1])


@pytest.mark.parametrize("slots", [0, 1, 16], ids=["no-slot-axis", "S1", "S16"])
@pytest.mark.parametrize("ftype", TYPES)
def test_biquad_step_cpu_is_coefficients_then_scan(ftype, slots):
    """On CPU tensors the wrapper is ``coefficients()`` + ``biquad_block()``
    bit for bit, outputs and state over three blocks, for every filter type,
    with and without the pool's slot axis (per-slot params)."""
    p = _params(np.random.default_rng(ftype), ftype, slots)
    step = lambda st, p, x: biquad_step(st, p, x, FS)  # noqa: E731
    _assert_same(_run(step, p, slots, 256, 3, seed=slots), _run(_reference, p, slots, 256, 3,
                                                                 seed=slots))


@pytest.mark.parametrize("n", [1, 2, 1023])
def test_biquad_step_cpu_edge_lengths(n):
    """The shortest blocks (the state's x2 and y2 carried through) and the
    longest the step takes, one type per slot."""
    p = _params(np.random.default_rng(n), None, 7)
    step = lambda st, p, x: biquad_step(st, p, x, FS)  # noqa: E731
    _assert_same(_run(step, p, 7, n, 3, seed=n), _run(_reference, p, 7, n, 3, seed=n))


@pytest.fixture
def spy(monkeypatch):
    """Counts ``BiquadFilter.process``'s calls of the step wrapper."""
    calls = []

    def wrapped(*args):
        calls.append(args[2].shape)
        return biquad_step(*args)

    monkeypatch.setattr(biquad_mod, "biquad_step", wrapped)
    return calls


@pytest.mark.parametrize("n", [1024, 4096])
def test_process_long_signals_bypass_the_step(spy, n):
    """Signals of 1,024 samples or more take the chunked Toeplitz solve:
    ``process`` and ``process_file`` never call the wrapper, and give
    ``biquad_block``'s file solve."""
    mdl = BiquadFilter(FS, 256)
    p = _params(np.random.default_rng(5), 0, 0)
    x = torch.tensor((0.3 * np.random.default_rng(6).standard_normal((2, n))).astype(np.float32))
    for fn in (mdl.process, mdl.process_file):
        st, y = fn(mdl.init_state(), p, x)
        want_y, want_df1 = scan.biquad_block(x, *coefficients(p, FS), mdl.init_state()["df1"])
        assert torch.equal(y, want_y) and torch.equal(st["df1"], want_df1)
    assert spy == []


@pytest.mark.parametrize("n", [256, 1023])
def test_process_streaming_blocks_take_the_step(spy, n):
    """Blocks shorter than 1,024 samples go through the wrapper, once a
    block."""
    mdl = BiquadFilter(FS, n)
    x = torch.zeros((2, n))
    mdl.process(mdl.init_state(), _params(np.random.default_rng(1), 3, 0), x)
    assert spy == [x.shape]


def test_chain_routes_streaming_but_not_file_mode(spy):
    """"Multiband Master" (11 biquads): its 256-sample streaming step calls
    the wrapper 11 times a block, its whole-file render of 4,096 samples
    never (a file shorter than 1,024 samples is one block, and takes it)."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.config import DEFAULT_PRESETS

    cfg = DEFAULT_PRESETS["Multiband Master"]
    x = (0.2 * np.random.default_rng(2).standard_normal((3 * 256, 1))).astype(np.float32)
    chain, state, tmap = build_chain(cfg, FS, 256, channels_in=1, device="cpu")
    chain.process_array(state, chain.targets(tmap), x)
    assert len(spy) == 3 * 11
    spy.clear()
    chain, state, tmap = build_chain(cfg, FS, 256, channels_in=1, device="cpu")
    chain.process_array(state, chain.targets(tmap), np.tile(x, (6, 1)), fast=True)
    assert spy == []


def _good(slots=4, n=256):
    p = {k: v.expand(slots).contiguous()
         for k, v in _params(np.random.default_rng(0), 0, 0).items()}
    return {"df1": torch.zeros((slots, 2, 4))}, p, torch.zeros((slots, 2, n))


BAD = {
    "x-float64": lambda st, p, x: (st, p, x.double()),
    "x-one-dim": lambda st, p, x: (st, p, x[0, 0]),
    "x-four-dims": lambda st, p, x: (st, p, x[None]),
    "x-empty": lambda st, p, x: (st, p, x[..., :0]),
    "x-file-length": lambda st, p, x: (st, p, torch.zeros(x.shape[:-1] + (1024,))),
    "df1-float64": lambda st, p, x: ({"df1": st["df1"].double()}, p, x),
    "df1-three-wide": lambda st, p, x: ({"df1": st["df1"][..., :3]}, p, x),
    "df1-other-slots": lambda st, p, x: ({"df1": st["df1"][:3]}, p, x),
    "param-float64": lambda st, p, x: (st, {**p, "q": p["q"].double()}, x),
    "param-other-slots": lambda st, p, x: (st, {**p, "cutoff_hz": p["cutoff_hz"][:3]}, x),
    "param-two-dims": lambda st, p, x: (st, {**p, "gain_db": p["gain_db"][None]}, x),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_biquad_step_rejects_bad_cpu_operands(case):
    """The shape and dtype checks hold on CPU tensors too, before the plain
    version runs."""
    with pytest.raises(ValueError):
        biquad_step(*BAD[case](*_good()), FS)


def test_biquad_step_takes_the_good_operands():
    st, y = biquad_step(*_good(), FS)
    assert y.shape == (4, 2, 256) and st["df1"].shape == (4, 2, 4)
