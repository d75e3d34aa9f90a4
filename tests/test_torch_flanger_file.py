"""The flanger's line solve (ops/kernels/flanger.py) on the CPU: the
wrapper takes its plain version there, which is the line recurrence
sample by sample bit for bit, with one feedback and mix a row or one for
all; ``Flanger.process_file`` calls the wrapper once a render, for every
file and channel, and the streaming ``process`` once a block, single or
slot-batched; the wrapper's operand checks and its floor on the tap's
reach.  Kernel K6 itself is held to the plain version on the card
(tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import DEFAULT_PRESETS
from aefs_tpu_torch.models import flanger as flanger_mod
from aefs_tpu_torch.models.flanger import Flanger
from aefs_tpu_torch.ops.kernels.flanger import D_MIN, MAX_HIST, flanger_file, flanger_file_plain

FS = 48000
JET = DEFAULT_PRESETS["Jet Flanger"][0]["params"]


def _operands(rng, lead, n, h, ca_lo, ca_hi, fb=0.7, mix=0.4):
    """Noise x and history, ca uniform in [ca_lo, ca_hi], random weights."""
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f32(0.3 * rng.standard_normal(lead + (n,))),
            torch.from_numpy(rng.integers(ca_lo, ca_hi + 1, lead + (n,)).astype(np.int32)),
            f32(rng.uniform(-0.6, 1.2, (4,) + lead + (n,))), f32(fb), f32(mix),
            f32(0.3 * rng.standard_normal(lead + (h,))))


def _per_sample(x, ca, w, fb, mix, hist):
    """The recurrence one sample at a time in float32 NumPy, each product
    and sum rounded once, in the kernel's order; each row with its own
    feedback and mix."""
    x, ca, w, hist = (t.numpy() for t in (x, ca, w, hist))
    fbs, mixes = (np.broadcast_to(t.numpy(), x.shape[:-1]) for t in (fb, mix))
    h, n = hist.shape[-1], x.shape[-1]
    y, v = np.empty_like(x), np.empty_like(x)
    for r in np.ndindex(x.shape[:-1]):
        fb, mix = fbs[r], mixes[r]
        line = np.concatenate([hist[r], np.zeros(n, np.float32)])
        for i in range(n):
            p = h + i - int(ca[r][i]) - 1
            tap = ((w[(0,) + r][i] * line[p] + w[(1,) + r][i] * line[p + 1])
                   + w[(2,) + r][i] * line[p + 2]) + w[(3,) + r][i] * line[p + 3]
            line[h + i] = x[r][i] + fb * tap
            y[r][i] = (np.float32(1.0) - mix) * x[r][i] + mix * tap
        v[r] = line[h:]
    return y, v


# Per row: feedback one a file (a pool's slot-wise (S, 1)), mix one a row.
ROWS = {"fb": np.array([[0.7], [-0.5], [0.9]]), "mix": np.array([[0.4, 1.0], [0.0, 0.3],
                                                                 [0.8, 0.5]])}


@pytest.mark.parametrize("lead,n,h,ca_lo,ca_hi,rows", [
    ((2,), 22 * 32 + 1, 60, D_MIN, D_MIN, False),  # every tap at the floor; last stretch 1
    ((2,), 700, 120, D_MIN, 118, False),  # the flanger's whole reach
    ((3, 2), 500, 200, 60, 199, False),  # three files, taps far back (K6: 58 at once)
    ((1,), 33, 40, 30, 39, False),  # a file shorter than its history
    ((3, 2), 300, 120, D_MIN, 119, True),  # feedback and mix one a row
], ids=["span1", "span22", "files3-span58", "short", "rows-fb-mix"])
def test_plain_is_the_per_sample_recurrence(lead, n, h, ca_lo, ca_hi, rows):
    """``flanger_file`` on CPU tensors (the plain version, stretches of
    D_MIN - 2 = 22 samples) equals the recurrence stepped sample by
    sample, bit for bit, y and v."""
    kw = {k: v.astype(np.float32) for k, v in ROWS.items()} if rows else {}
    ops = _operands(np.random.default_rng(n + h), lead, n, h, ca_lo, ca_hi, **kw)
    y, v = flanger_file(*ops)
    want_y, want_v = _per_sample(*ops)
    assert np.array_equal(y.numpy(), want_y) and np.array_equal(v.numpy(), want_v)


@pytest.mark.parametrize("ca_lo,ca_hi", [(D_MIN - 1, 50), (D_MIN, 100)],
                         ids=["too-near", "past-history"])
def test_plain_rejects_taps_outside_the_line(ca_lo, ca_hi):
    """A tap nearer than the floor D_MIN (one that could read the stretch
    it is in), or one before the history."""
    with pytest.raises(ValueError):
        flanger_file(*_operands(np.random.default_rng(0), (2,), 300, 100, ca_lo, ca_hi))


@pytest.fixture
def spy(monkeypatch):
    """Records the x shape of each call ``Flanger`` makes of the wrapper."""
    calls = []

    def wrapped(x, *args):
        calls.append(tuple(x.shape))
        return flanger_file(x, *args)

    monkeypatch.setattr(flanger_mod, "flanger_file", wrapped)
    return calls


@pytest.mark.parametrize("files", [(), (3,)], ids=["one-file", "three-files"])
def test_process_file_calls_the_solve_once(spy, files):
    """One call a render, for every file and channel, on the padded
    length; and the streaming ``process`` one for a 4096-sample block."""
    mdl = Flanger(FS, 256)
    p = {k: torch.tensor(float(v)) for k, v in JET.items()}
    st = {k: v.expand(files + v.shape).clone() for k, v in mdl.init_state().items()}
    x = torch.zeros(files + (2, 1000))
    mdl.process_file(st, p, x)
    assert spy == [files + (2, 1024)]
    spy.clear()
    mdl.process(mdl.init_state(), p, torch.zeros((2, 4096)))
    assert spy == [(2, 4096)]


# The second slot's own feedback and mix: the step's (S, 1) rows.
SLOT_B = {"feedback": -0.5, "mix": 0.3}


@pytest.mark.parametrize("blocksize,fast,slots,want", [
    (256, True, 1, [(2, 6 * 256)]),
    (256, False, 1, [(2, 256)] * 6),
    (128, False, 1, [(2, 256)] * 12),  # each block padded to one chunk
    (256, False, 2, [(2, 2, 256)] * 6),
], ids=["file", "stream256", "stream128", "slots2"])
def test_chain_renders_through_one_solve(spy, blocksize, fast, slots, want):
    """"Jet Flanger": a whole-file render calls the solve once, a stream
    once a block, and a slot-batched (2, 1, 256) step once for both
    slots, each slot with its own feedback and mix and bit-equal to its
    own single chain."""
    x = (0.2 * np.random.default_rng(3).standard_normal((6 * 256, 1))).astype(np.float32)
    cfg = DEFAULT_PRESETS["Jet Flanger"]
    if slots == 1:
        chain, state, tmap = build_chain(cfg, FS, blocksize, channels_in=1, device="cpu")
        chain.process_array(state, chain.targets(tmap), x, fast=fast)
        assert spy == want
        return
    refs, targets = [], []
    for own in ({}, SLOT_B):
        chain, state, tmap = build_chain(cfg, FS, 256, channels_in=1, device="cpu")
        tmap["jf1"].update(own)
        targets.append(chain.targets(tmap))
        refs.append(chain.process_array(state, targets[-1], x)[1])
    spy.clear()
    targets = tuple({k: torch.stack([a[k], b[k]]) for k in a} for a, b in zip(*targets))
    state, ys = chain.batch_state(chain.init_state(), slots), []
    for k in range(6):
        xb = torch.from_numpy(np.repeat(x[None, k * 256:(k + 1) * 256, 0], slots, 0)[:, None])
        state, y = chain.process_block(state, targets, xb)
        ys.append(y)
    assert spy == want
    got = torch.cat(ys, -1)
    for s in range(slots):
        assert np.array_equal(got[s].numpy().T, refs[s]), s


def _good():
    return _operands(np.random.default_rng(1), (2,), 256, 100, 24, 99)


BAD = {
    "x-float64": lambda x, ca, w, fb, mix, h: (x.double(), ca, w, fb, mix, h),
    "x-one-dim": lambda x, ca, w, fb, mix, h: (x[0], ca[0], w[:, 0], fb, mix, h[0]),
    "x-empty": lambda x, ca, w, fb, mix, h: (x[..., :0], ca[..., :0], w[..., :0], fb, mix, h),
    "ca-float32": lambda x, ca, w, fb, mix, h: (x, ca.float(), w, fb, mix, h),
    "ca-int64": lambda x, ca, w, fb, mix, h: (x, ca.long(), w, fb, mix, h),
    "ca-short": lambda x, ca, w, fb, mix, h: (x, ca[..., 1:], w, fb, mix, h),
    "w-three": lambda x, ca, w, fb, mix, h: (x, ca, w[:3], fb, mix, h),
    "w-float64": lambda x, ca, w, fb, mix, h: (x, ca, w.double(), fb, mix, h),
    "w-rows-first": lambda x, ca, w, fb, mix, h: (x, ca, w.movedim(0, 1), fb, mix, h),
    "hist-other-rows": lambda x, ca, w, fb, mix, h: (x, ca, w, fb, mix, h[:1]),
    "hist-empty": lambda x, ca, w, fb, mix, h: (x, ca, w, fb, mix, h[..., :0]),
    "hist-too-long": lambda x, ca, w, fb, mix, h: (
        x, ca, w, fb, mix, torch.zeros((2, MAX_HIST + 1))),
    "hist-float64": lambda x, ca, w, fb, mix, h: (x, ca, w, fb, mix, h.double()),
    "fb-one-dim": lambda x, ca, w, fb, mix, h: (x, ca, w, fb.expand(3), mix, h),  # not 2 rows
    "mix-float64": lambda x, ca, w, fb, mix, h: (x, ca, w, fb, mix.double(), h),
    "w-other-device": lambda x, ca, w, fb, mix, h: (x, ca, w.to("meta"), fb, mix, h),
    "hist-other-device": lambda x, ca, w, fb, mix, h: (x, ca, w, fb, mix, h.to("meta")),
    "fb-other-device": lambda x, ca, w, fb, mix, h: (x, ca, w, fb.to("meta"), mix, h),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_flanger_file_rejects_bad_operands(case):
    """Dtypes, shapes and devices are checked on CPU tensors too, before
    the plain version runs."""
    with pytest.raises(ValueError):
        flanger_file(*BAD[case](*_good()))


def test_flanger_file_takes_the_good_operands():
    y, v = flanger_file(*_good())
    assert y.shape == v.shape == (2, 256) and flanger_file.launches == 0
    assert torch.equal(y, flanger_file_plain(*_good())[0])
