"""The parallel container and the multiband expansion in the PyTorch port:
against JAX (streaming and file mode, state trees by path, a JAX stream
continued in the port), the two ``build_chain`` repairs (``multiband``
expands; branch-config values seed the lifted targets), live-parameter
routing through the engine, the skipped-entry numbering, and the
crossover's allpass-flat sum."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aefs_tpu.core.chain import build_chain as jax_build
from aefs_tpu_torch.core.chain import build_chain
from aefs_tpu_torch.core.config import DEFAULT_PRESETS
from aefs_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from aefs_tpu_torch.engine.engine import AudioEngine
from aefs_tpu_torch.models import ParallelChains

from helpers import noise
from oracles import err_dbfs
from test_torch_models import _leaves, assert_states_close, run_both

FS = 48000
N = 256

FILTER = {"effect_id": "f", "type": "filter",
          "params": {"filter_type": 0, "cutoff_hz": 1500, "q": 0.707}}
DELAY = {"effect_id": "d", "type": "delay",
         "params": {"delay_ms": 120, "feedback": 0.3, "mix_dry": 0.0, "mix_wet": 1.0,
                    "offset_ms": 0}}
PARALLEL = {"effect_id": "p", "type": "parallel", "params": {"gain_0": 0.6, "gain_1": 0.4},
            "branches": [[FILTER, DELAY], [{**FILTER, "effect_id": "f2",
                                            "params": {"filter_type": 1, "cutoff_hz": 3000}}]]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _render(cfgs, x, blocksize=N, fast=False):
    chain, state, tmap = build_chain(cfgs, FS, blocksize, channels_in=x.shape[1], device="cpu")
    return chain.process_array(state, chain.targets(tmap), x, fast=fast)[1]


@pytest.mark.parametrize("blocksize,fast", [(N, False), (4096, True)], ids=["stream", "file"])
def test_parallel_vs_jax(blocksize, fast):
    """Streaming, and file mode with the branch delay's file statics baked
    through the container's ``file_mode`` flag."""
    x = noise(6 * 4096 if fast else 40 * N, amp=0.2)
    out, st, jout, jst = run_both([copy.deepcopy(PARALLEL)], x, blocksize, fast=fast)
    assert err_dbfs(out, jout) <= -90, err_dbfs(out, jout)
    assert_states_close(st, jst)


def test_parallel_equals_sum_of_branches():
    x = noise(16 * N, amp=0.2)
    got = _render([copy.deepcopy(PARALLEL)], x)
    a = _render([copy.deepcopy(FILTER), copy.deepcopy(DELAY)], x)
    b = _render([PARALLEL["branches"][1][0]], x)
    assert err_dbfs(got, np.clip(0.6 * a + 0.4 * b, -1, 1)) <= -110


def test_multiband_compact_builds_the_shipped_expansion():
    """A compact ``multiband`` config builds the same chain, state and
    targets as the shipped, expanded "Multiband Master"."""
    shipped = DEFAULT_PRESETS["Multiband Master"]
    comps = [br[-1] for br in shipped[0]["branches"]]
    compact = [{"effect_id": "mm", "type": "multiband", "crossover_hz": [150.0, 2000.0],
                "branches": [[c] for c in comps]}] + shipped[1:]
    built = [build_chain(copy.deepcopy(c), FS, N, device="cpu") for c in (compact, shipped)]
    (ca, sa, ta), (cb, sb, tb) = built
    assert [(e, m.kind, sorted(m.PARAMS)) for e, m in ca.effects] == \
        [(e, m.kind, sorted(m.PARAMS)) for e, m in cb.effects]
    la, lb = _leaves(state_to_numpy(sa)), _leaves(state_to_numpy(sb))
    assert la.keys() == lb.keys() and all(np.array_equal(la[k], lb[k]) for k in la)
    assert ta == tb
    assert len(dict(ca.effects)["mm"].branches) == 3
    assert ta["mm"]["b0_3_threshold_db"] == -20.0 and ta["mm"]["b1_0_cutoff_hz"] == 150.0


def test_branch_config_seeds_lifted_targets():
    """A branch effect's configured value, not its spec default, is the
    lifted param's initial current value and target (as in JAX)."""
    chain, state, tmap = build_chain([copy.deepcopy(PARALLEL)], FS, N, device="cpu")
    jchain, jstate, jtmap = jax_build([copy.deepcopy(PARALLEL)], FS, N)
    assert tmap["p"]["b0_1_delay_ms"] == 120.0 and tmap["p"]["b0_0_cutoff_hz"] == 1500.0
    assert tmap["p"]["gain_1"] == 0.4 and "b0_1_offset_ms" in tmap["p"]
    assert tmap == {k: {n: float(v) for n, v in d.items()} for k, d in jtmap.items()}
    assert float(state["params"][0]["b0_1_delay_ms"]) == 120.0
    assert float(state["params"][0]["b1_0_filter_type"]) == 1.0


def test_engine_update_param_routes_and_glides():
    """``update_param("p", "b0_1_delay_ms", ...)`` reaches the branch delay
    and glides at the delay's own step (2 samples per block)."""
    eng = AudioEngine(device="cpu")
    eng.build_chain([copy.deepcopy(PARALLEL)])
    eng.update_param("p", "b0_1_delay_ms", 130.0)
    eng.update_param("p", "b0_9_delay_ms", 1.0)  # no such lifted param: warning only
    for _ in range(10):
        eng.process_stream_block(np.zeros((N, 1), np.float32))
    cur = float(eng.chain_state["params"][0]["b0_1_delay_ms"])
    assert abs(cur - (120.0 + 10 * 2000.0 / FS)) < 1e-3
    assert eng._targets_map["p"]["b0_1_delay_ms"] == 130.0
    assert eng.last_chain_config[0]["params"]["b0_1_delay_ms"] == 130.0


def test_unknown_branch_type_skipped_without_renumbering():
    cfg = {"effect_id": "p", "type": "parallel", "params": {},
           "branches": [[{"type": "nope", "params": {}}, copy.deepcopy(FILTER)],
                        [copy.deepcopy(PARALLEL)]]}  # containers do not nest
    chain, _, tmap = build_chain([cfg], FS, N, device="cpu")
    model = dict(chain.effects)["p"]
    assert "b0_1_cutoff_hz" in model.PARAMS and "b0_0_cutoff_hz" not in model.PARAMS
    assert model.branches[1] == [] and tmap["p"]["b0_1_cutoff_hz"] == 1500.0
    x = noise(4 * N, amp=0.2)
    got = _render([cfg], x)
    assert err_dbfs(got, np.clip(x + _render([copy.deepcopy(FILTER)], x), -1, 1)) <= -110


def test_map_state_recurses_into_branches():
    """A branch delay's ring row is a lockstep counter one level down."""
    chain, state, _ = build_chain([copy.deepcopy(PARALLEL)], FS, N, device="cpu")
    model = chain.effects[0][1]
    assert isinstance(model, ParallelChains)
    tags = model.map_state(lambda v: "batched", lambda v: "lockstep", state["fx"][0])
    assert tags["branches"][0][1]["row"] == "lockstep"
    assert tags["branches"][0][0]["df1"] == "batched"


def test_jax_stream_continues_in_the_port():
    x = noise(24 * N, amp=0.2, seed=4)
    k = 10
    cfg = [copy.deepcopy(PARALLEL)]
    jchain, jstate, jtmap = jax_build(cfg, FS, N, channels_in=2)
    jtargets = jchain.targets(jtmap)
    jst, _ = jchain.process_array(jstate, jtargets, x[: k * N])
    handoff = jax.tree.map(np.asarray, jst)
    jst2, ref = jchain.process_array(jax.tree.map(jnp.asarray, handoff), jtargets, x[k * N:])
    chain, _, tmap = build_chain(cfg, FS, N, channels_in=2, device="cpu")
    st, got = chain.process_array(state_from_numpy(handoff, "cpu"), chain.targets(tmap),
                                  x[k * N:])
    assert err_dbfs(got, ref) <= -90, err_dbfs(got, ref)
    assert_states_close(state_to_numpy(st), jax.tree.map(np.asarray, jst2))


@pytest.mark.parametrize("xover", [[1000.0], [250.0, 2500.0]])
def test_bare_crossover_sums_allpass_flat(xover):
    """Empty bands sum to an allpass: |H(f)| == 1 across the audio band
    (tests/test_multiband.py's bound, float32 biquad cascades)."""
    x = np.zeros((65536, 2), np.float32)
    x[1024] = 1.0
    cfg = [{"effect_id": "mb", "type": "multiband", "crossover_hz": xover, "branches": []}]
    y = _render(cfg, x, blocksize=4096)
    h = np.fft.rfft(y[:, 0], 65536)
    f = np.fft.rfftfreq(65536, 1.0 / FS)
    band = (f > 20.0) & (f < 20000.0)
    err = float(np.max(np.abs(np.abs(h[band]) - 1.0)))
    assert err < 2e-3, err


@pytest.mark.parametrize("name", ["parallel", "Multiband Master"])
def test_file_mode_file_axis(name):
    """The container's whole-file path over three files on a leading file
    axis (its gains 0-dim, shared): each file bit-equal to its own call."""
    from test_torch_batch import file_axis_vs_per_file

    cfg = [copy.deepcopy(PARALLEL)] if name == "parallel" else DEFAULT_PRESETS[name]
    file_axis_vs_per_file(cfg)
