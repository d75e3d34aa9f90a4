"""The plain reference (benchmark/reference/) against the port's CPU path
on a few blocks of each configuration, streaming and whole-file, and the
roofline counts against PERF.md's kernel table."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness, roofline
from benchmark.refchain import render_mono
from benchmark.streams import session_inputs

CONFIGS = ["flagship", "multiband_master"]


def _config(name):
    return json.loads((harness.ROOT / f"benchmark/configs/{name}.json").read_text())


def _err(a, b):
    return 20 * np.log10(max(float(np.max(np.abs(a - b))), 1e-300))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", CONFIGS)
def test_streaming_matches_the_port(name):
    from aefs_tpu_torch.core.chain import build_chain

    cfg = _config(name)
    fs, n = cfg["sample_rate"], cfg["blocksize"]
    x = session_inputs(4, 1, 40 * n, fs)[0]
    chain, state, tmap = build_chain(cfg["chain"], fs, n, channels_in=1, device="cpu")
    _, got = chain.process_array(state, chain.targets(tmap), x[:, None])
    ref = render_mono(x, cfg["chain"], fs)
    assert _err(got.T, ref) <= -80


@pytest.mark.parametrize("name", CONFIGS)
def test_file_mode_matches_the_port(name):
    from aefs_tpu_torch.engine.engine import process_offline

    cfg = _config(name)
    fs = cfg["sample_rate"]
    x = np.stack([session_inputs(9, 2, fs // 2, fs)[s] for s in range(2)], axis=1)
    mono, got = process_offline(cfg["chain"], x, fs, device="cpu")
    ref = np.clip(render_mono(x.astype(np.float64).mean(axis=1), cfg["chain"], fs), -1, 1)
    assert _err(got.T, ref) <= -80


def test_a_lower_precision_fails():
    """The control: the same reference with every effect's output in
    bfloat16 lies far outside the limits the cells use."""
    cfg = _config("flagship")
    x = session_inputs(5, 1, 48000, 48000)[0]
    ref = render_mono(x, cfg["chain"], 48000)
    low = render_mono(x, cfg["chain"], 48000, "bfloat16")
    worst_limit = max(harness.load_json(p)["err_dbfs"]["limit"]
                      for p in (harness.ROOT / "benchmark/limits").glob("*.json"))
    assert _err(low, ref) > worst_limit + 10


def test_float32_biquads_are_computed_in_float32():
    """``float32:filter``: the biquads alone in float32, the rest float64;
    a sequential float32 recursion stays close to float64."""
    cfg = _config("multiband_master")
    x = session_inputs(6, 1, 24000, 48000)[0]
    ref = render_mono(x, cfg["chain"], 48000)
    low = render_mono(x, cfg["chain"], 48000, "float32:filter")
    assert -130 < _err(low, ref) < -80


def test_roofline_counts_give_perf_md_bounds():
    n_bytes, flops = roofline.k1_work(1, 256, 1920)
    assert n_bytes == 19512  # 19.5 KB
    assert abs(roofline.bound_s(n_bytes, flops) - 5.8e-9) < 0.05e-9
    n_bytes, flops = roofline.k2_work(892800, roofline.reverb_lags(48000))
    assert roofline.comb_chunk(roofline.reverb_lags(48000)) == 1408
    assert abs(n_bytes - 14.4e6) < 0.05e6
    assert abs(roofline.bound_s(n_bytes, flops) - 4.3e-6) < 0.05e-6
