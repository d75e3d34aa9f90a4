"""The port's CLI on the CPU against the JAX package's file render."""

import numpy as np
import pytest
import torch

from aefs_tpu.core.config import DEFAULT_PRESETS
from aefs_tpu.engine.engine import process_offline as jax_offline
from aefs_tpu.engine.wavio import read_wav_file as jax_read
from aefs_tpu.engine.wavio import write_wav_file as jax_write
from aefs_tpu_torch import cli
from aefs_tpu_torch.engine.wavio import read_wav_file

from helpers import bursts, tones

FS = 48000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cli_vs_jax(tmp_path, preset, x):
    """The CLI's render of ``x`` with ``preset`` against the JAX render,
    both written as 16-bit WAVs: at most one step apart."""
    src = tmp_path / "in.wav"
    jax_write(str(src), x, FS)
    out = tmp_path / "out.wav"
    assert cli.main([str(src), str(out), "--preset", preset, "--device", "cpu"]) == 0

    audio, fs = jax_read(str(src))
    _, ref = jax_offline(DEFAULT_PRESETS[preset], audio, fs)
    jax_write(str(tmp_path / "ref.wav"), ref, fs)
    got, fs_got = read_wav_file(str(out))
    want, _ = read_wav_file(str(tmp_path / "ref.wav"))
    assert fs_got == FS and got.shape == want.shape == (x.shape[0], 2)
    lsb = np.max(np.abs(got.astype(np.float64) - want.astype(np.float64))) * 32768.0
    assert lsb <= 1.0 + 1e-9, lsb


def test_cli_rain_delay_matches_jax_render(tmp_path):
    x = (tones(FS // 2, fs=FS) + bursts(FS // 2, amp=0.2)).astype(np.float32)
    _cli_vs_jax(tmp_path, "Rain Delay", x)


def test_cli_lush_chorus_matches_jax_render(tmp_path):
    """A modulation preset through the CLI: chorus (read through K3's entry)
    into the reverb, against the JAX render to one 16-bit step."""
    _cli_vs_jax(tmp_path, "Lush Chorus", tones(FS // 2, fs=FS))


def test_cli_master_bus_matches_jax_render(tmp_path):
    """A dynamics preset through the CLI: compressor, width and look-ahead
    limiter, against the JAX render to one 16-bit step."""
    _cli_vs_jax(tmp_path, "Master Bus", bursts(FS // 2, amp=0.6))


def test_cli_list_presets(capsys):
    assert cli.main(["--list-presets"]) == 0
    assert "Rain Delay: delay -> reverb" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--batch", "out_dir"], ["--shard"], ["--checkpoint", "ck"]])
def test_cli_unported_modes_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main([str(tmp_path / "a.wav"), str(tmp_path / "b.wav"), *flag, "--device", "cpu"])
