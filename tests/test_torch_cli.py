"""The port's CLI on the CPU against the JAX package's: single-file
renders, --batch, and --checkpoint/--resume (mirroring
tests/test_checkpoint.py's CLI cases), to one 16-bit step of JAX and bit
for bit within the port."""

import json
import os
import shutil

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


def _write_mono(path, seconds, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(int(seconds * FS)) * 0.2).astype(np.float32)[:, None]
    jax_write(str(path), x, FS)


DELAY_CFG = [{"effect_id": "d", "type": "delay",
              "params": {"delay_ms": 150, "feedback": 0.5, "mix_dry": 1.0,
                         "mix_wet": 1.0, "offset_ms": 0}}]


def test_cli_batch_matches_jax_batch(tmp_path):
    """--batch over three ragged inputs, two of them sharing a basename:
    the outputs are de-collided as JAX's are, and each is within one 16-bit
    step of JAX's --batch output."""
    from aefs_tpu.cli import main as jax_main

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ins = [tmp_path / "a" / "x.wav", tmp_path / "b" / "x.wav", tmp_path / "a" / "y.wav"]
    jax_write(str(ins[0]), bursts(FS // 3, amp=0.3), FS)
    jax_write(str(ins[1]), tones(FS // 2, fs=FS), FS)
    jax_write(str(ins[2]), bursts(FS // 4, channels=1, amp=0.2, seed=5), FS)
    args = [*map(str, ins), "--preset", "Rain Delay"]
    assert cli.main(["--batch", str(tmp_path / "port"), *args, "--device", "cpu"]) == 0
    assert jax_main(["--batch", str(tmp_path / "jax"), *args]) == 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["x.1.wav", "x.wav",
                                                                              "y.wav"]
    for name in names:
        got, _ = read_wav_file(str(tmp_path / "port" / name))
        want, _ = read_wav_file(str(tmp_path / "jax" / name))
        assert got.shape == want.shape
        assert np.max(np.abs(got.astype(np.float64) - want)) * 32768.0 <= 1.0 + 1e-9


def test_cli_batch_shard_on_one_device_is_the_same(tmp_path):
    src = tmp_path / "in.wav"
    jax_write(str(src), tones(FS // 4, fs=FS), FS)
    for d, extra in (("plain", []), ("shard", ["--shard"])):
        assert cli.main(["--batch", str(tmp_path / d), str(src), "--preset", "Slapback Echo",
                         "--device", "cpu", *extra]) == 0
    assert (tmp_path / "plain" / "in.wav").read_bytes() == (tmp_path / "shard" / "in.wav").read_bytes()


def _ckpt_run(tmp_path, in_wav, out, ck, *extra):
    cfg_path = tmp_path / "chain.json"
    cfg_path.write_text(json.dumps(DELAY_CFG))
    return cli.main([str(in_wav), str(out), "--config", str(cfg_path), "--device", "cpu",
                     "--checkpoint", str(ck), "--checkpoint-every", "0.4", *extra])


def test_cli_checkpoint_kill_and_resume_bit_exact(tmp_path):
    """--checkpoint, a simulated kill and --resume: the job redoes only the
    tail from the last committed generation, and the WAV is byte-equal to
    an uninterrupted --checkpoint run and within one 16-bit step of JAX's."""
    from aefs_tpu.cli import main as jax_main

    in_wav = tmp_path / "in.wav"
    _write_mono(in_wav, 1.2, seed=3)
    assert _ckpt_run(tmp_path, in_wav, tmp_path / "ref.wav", tmp_path / "ck_ref") == 0
    ck = tmp_path / "ck"
    assert _ckpt_run(tmp_path, in_wav, tmp_path / "resumed.wav", ck) == 0
    progress = json.loads((ck / "progress.json").read_text())
    assert progress["dir"] == f"gen-{progress['done_samples']}"
    assert any(n.startswith("chunk-") for n in os.listdir(ck / "chunks"))
    assert not (ck / progress["dir"] / "partial.npy").exists()
    (tmp_path / "resumed.wav").unlink()
    assert _ckpt_run(tmp_path, in_wav, tmp_path / "resumed.wav", ck, "--resume") == 0
    assert (tmp_path / "ref.wav").read_bytes() == (tmp_path / "resumed.wav").read_bytes()

    cfg_path = tmp_path / "chain.json"
    assert jax_main([str(in_wav), str(tmp_path / "jax.wav"), "--config", str(cfg_path),
                     "--checkpoint", str(tmp_path / "ck_jax"), "--checkpoint-every", "0.4"]) == 0
    got, _ = read_wav_file(str(tmp_path / "ref.wav"))
    want, _ = read_wav_file(str(tmp_path / "jax.wav"))
    assert np.max(np.abs(got.astype(np.float64) - want)) * 32768.0 <= 1.0 + 1e-9


def test_cli_resume_rejects_different_input(tmp_path):
    in_wav, other = tmp_path / "in.wav", tmp_path / "other.wav"
    _write_mono(in_wav, 0.6, seed=8)
    _write_mono(other, 0.9, seed=9)
    assert _ckpt_run(tmp_path, in_wav, tmp_path / "out.wav", tmp_path / "ck") == 0
    with pytest.raises(SystemExit, match="different input"):
        _ckpt_run(tmp_path, other, tmp_path / "out.wav", tmp_path / "ck", "--resume")


def test_cli_resume_ignores_uncommitted_generation(tmp_path):
    """A kill after a newer generation was written but before progress.json
    named it: the resume continues from the committed one."""
    in_wav = tmp_path / "in.wav"
    _write_mono(in_wav, 1.2, seed=5)
    cfg_path = tmp_path / "chain.json"
    cfg_path.write_text(json.dumps(DELAY_CFG))
    assert cli.main([str(in_wav), str(tmp_path / "ref.wav"), "--config", str(cfg_path),
                     "--device", "cpu"]) == 0
    ck = tmp_path / "ck"
    assert _ckpt_run(tmp_path, in_wav, tmp_path / "resumed.wav", ck) == 0
    progress = json.loads((ck / "progress.json").read_text())
    shutil.copytree(ck / progress["dir"], ck / f"gen-{int(progress['done_samples']) + 19200}")
    assert _ckpt_run(tmp_path, in_wav, tmp_path / "resumed.wav", ck, "--resume") == 0
    a, _ = read_wav_file(str(tmp_path / "ref.wav"))
    b, _ = read_wav_file(str(tmp_path / "resumed.wav"))
    np.testing.assert_array_equal(a, b)


def test_cli_recheckpoint_keeps_irs_and_profiles(tmp_path):
    """A resumed job that checkpoints again carries the session's custom IR
    into the new generation, and stitches to an uninterrupted run."""
    from aefs_tpu_torch.core.chain import build_chain
    from aefs_tpu_torch.core.config import FILE_SUPERBLOCK
    from aefs_tpu_torch.core.fileopts import file_static_overrides
    from aefs_tpu_torch.engine.checkpoint import ir_static_overrides, save_session

    chunk = FILE_SUPERBLOCK
    n = 4 * chunk
    rng = np.random.default_rng(21)
    mono = (rng.standard_normal((n, 1)) * 0.25).astype(np.float32)
    ir = (rng.standard_normal((2, 9973)) * np.exp(-np.arange(9973) / 2500.0)).astype(np.float32) * 0.2
    cfg = [{"effect_id": "cv", "type": "convreverb",
            "params": {"ir_seconds": 0.5, "mix_dry": 0.7, "mix_wet": 0.5}}]
    irs = {"cv": (ir, FS)}
    overrides = file_static_overrides(cfg)
    for eid, ov in ir_static_overrides(irs, cfg, FS).items():
        overrides.setdefault(eid, {}).update(ov)

    def fresh():
        chain, state, tmap = build_chain(cfg, FS, chunk, channels_in=1, channels_out=2,
                                         static_overrides=overrides, device="cpu")
        return chain, state, tmap, chain.targets(tmap)

    chain, state, tmap, targets = fresh()
    state, y = chain.process_array(state, targets, mono[:chunk])
    ck = tmp_path / "ck"
    os.makedirs(ck / "chunks")
    np.save(str(ck / "chunks" / f"chunk-0-{chunk}.npy"), np.clip(y, -1.0, 1.0))
    save_session(str(ck / f"gen-{chunk}"), cfg, tmap, state, custom_irs=irs, fs=FS)
    (ck / "progress.json").write_text(json.dumps(
        {"done_samples": chunk, "n_samples": n, "fs": FS, "dir": f"gen-{chunk}"}))

    out = cli.process_resumable(cfg, mono, FS, str(ck), resume=True, every_s=chunk / FS,
                                device="cpu")
    progress = json.loads((ck / "progress.json").read_text())
    assert progress["dir"] != f"gen-{chunk}"
    meta = json.loads((ck / progress["dir"] / "session.json").read_text())
    assert meta["custom_irs"] and meta["fs"] == FS

    chain, st, _, targets = fresh()
    ref = []
    for i in range(0, n, chunk):
        st, yy = chain.process_array(st, targets, mono[i:i + chunk])
        ref.append(np.clip(yy, -1.0, 1.0))
    np.testing.assert_array_equal(out, np.concatenate(ref))


def test_cli_device_from_aefs_platform(tmp_path, monkeypatch, capsys):
    """Without --device the CLI takes $AEFS_PLATFORM, else the card."""
    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    jax_write(str(src), tones(FS // 10, fs=FS), FS)
    monkeypatch.setenv("AEFS_PLATFORM", "cpu")
    assert cli.main([str(src), str(out)]) == 0
    assert "device: cpu" in capsys.readouterr().out
    if not torch.cuda.is_available():
        monkeypatch.delenv("AEFS_PLATFORM")
        with pytest.raises(SystemExit, match="no CUDA card"):
            cli.main([str(src), str(out)])
