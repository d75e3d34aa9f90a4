"""Session checkpoint/resume (port of aefs_tpu/engine/checkpoint.py).

A checkpoint holds the chain config, the live parameter targets and the
full audio-state tree (ring buffers, filter taps, phasors), so a
long-running session or a long file job resumes exactly where it stopped.

Format, shared with the JAX package: a directory with ``session.json``
(config, targets, format metadata) and ``state-{gen}.npz`` (the state's
leaves as ``leaf_{i}``, plus any uploaded IRs and learned noise profiles).
The leaves are stored in ``jax.tree.flatten``'s order
(``core/convert.py:flatten_like_jax``), so a session saved by either
package resumes in the other.  A sharded state (``parallel/mesh.py``'s
``ShardedState``) is saved as the one slot-axis tree its shards join into,
and a rebuild onto a sharded template is split as the template is.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading

import numpy as np
import torch

from aefs_tpu_torch.core.convert import flatten_like_jax, unflatten_like_jax

FORMAT_VERSION = 1

# Per-directory save serialization: concurrent saves to one directory would
# otherwise both read gen=N and race their generation files and the
# manifest swap.  Process-local by design.
_save_locks: dict[str, threading.Lock] = {}
_save_locks_guard = threading.Lock()


def _dir_lock(path: str) -> threading.Lock:
    key = os.path.abspath(path)
    with _save_locks_guard:
        return _save_locks.setdefault(key, threading.Lock())


def remap_profiles(noise_profiles, saved_fs, fs):
    """Re-bin learned spectral noise profiles from ``saved_fs`` onto the
    analysis grid of ``fs``: bin k names the frequency k*fs/window, so raw
    bins carried across a rate change would gate the wrong frequencies.
    Linear interpolation in frequency, edge-clamped.  No-op when the rates
    match or either rate is unknown."""
    if (not noise_profiles or not saved_fs or not fs
            or int(saved_fs) == int(fs)):
        return dict(noise_profiles or {})
    out = {}
    for eid, prof in noise_profiles.items():
        prof = np.asarray(prof, np.float32)
        bins = prof.shape[-1]
        # target bin k sits at k*fs/W -> position k*fs/saved_fs in saved bins
        pos = np.arange(bins, dtype=np.float64) * (float(fs) / float(saved_fs))
        flat = prof.reshape(-1, bins)
        rem = np.stack(
            [np.interp(pos, np.arange(bins), row) for row in flat])
        out[eid] = rem.reshape(prof.shape).astype(np.float32)
    return out


def ir_static_overrides(custom_irs: dict, chain_config, fs: int) -> dict:
    """Static-override map carrying uploaded convreverb IRs into a chain
    build, resampled when the IR WAV's rate differs from the build rate.
    A chain rebuilt without the session's IR has differently-shaped
    ``spec_hist`` leaves, and every resume would fail the shape check."""
    ids = {c.get("effect_id") for c in chain_config}
    out = {}
    for eid, (ir, ir_fs) in custom_irs.items():
        if eid not in ids:
            continue
        if ir_fs != fs:
            from aefs_tpu_torch.engine.wavio import resample_bandlimited

            n_out = max(8, int(round(ir.shape[1] * fs / ir_fs)))
            ir = resample_bandlimited(ir, n_out)
        out[eid] = {"ir": ir}
    return out


def profile_static_overrides(noise_profiles: dict, chain_config) -> dict:
    """Static-override map carrying learned spectral noise profiles into a
    chain build.  A profile changes no state shape, but a resume that
    dropped it would silently revert the gate to its scalar threshold.
    Callers resuming at another rate than ``meta["fs"]`` pass the profiles
    through ``remap_profiles`` first."""
    ids = {c.get("effect_id") for c in chain_config}
    return {
        eid: {"noise_profile": np.asarray(prof, np.float32)}
        for eid, prof in noise_profiles.items()
        if eid in ids
    }


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_session(path: str, chain_config, targets_map: dict, state,
                 custom_irs: dict | None = None,
                 noise_profiles: dict | None = None,
                 fs: int | None = None) -> None:
    """Write a session checkpoint directory, crash-safe and serialized.

    The state lands in a fresh generation-named file and ``session.json``
    (the manifest naming it) is swapped in last with ``os.replace``: a kill
    at any instant leaves the previous complete checkpoint or the new one,
    never a torn mix.  Saves to one directory serialize on a process-local
    lock; temp files are mkstemp-unique.  ``fs`` records the session rate
    so loads at another rate can remap the profiles.  A sharded ``state``
    is saved joined."""
    if hasattr(state, "join"):
        state = state.join()
    with _dir_lock(path):
        _save_session_locked(path, chain_config, targets_map, state,
                             custom_irs, noise_profiles, fs)


def _save_session_locked(path, chain_config, targets_map, state,
                         custom_irs, noise_profiles, fs):
    os.makedirs(path, exist_ok=True)
    manifest = os.path.join(path, "session.json")
    gen = 0
    if os.path.exists(manifest):
        try:
            with open(manifest) as f:
                gen = int(json.load(f).get("gen", 0)) + 1
        except (OSError, ValueError):
            gen = 1
    leaves = [_to_numpy(leaf) for leaf in flatten_like_jax(state)]
    state_file = f"state-{gen}.npz"
    # Uploaded IRs and learned profiles ride in the same npz (extra keys
    # are invisible to the leaf_{i} reader), so a checkpoint resumes in a
    # fresh process that never saw them.
    ir_meta, ir_arrays = [], {}
    for j, (eid, (ir, ir_fs)) in enumerate(sorted((custom_irs or {}).items())):
        ir_meta.append({"effect_id": eid, "fs": int(ir_fs), "key": f"ir_{j}"})
        ir_arrays[f"ir_{j}"] = np.asarray(ir, np.float32)
    prof_meta, prof_arrays = [], {}
    for j, (eid, prof) in enumerate(sorted((noise_profiles or {}).items())):
        prof_meta.append({"effect_id": eid, "key": f"profile_{j}"})
        prof_arrays[f"profile_{j}"] = np.asarray(prof, np.float32)
    fd, tmp = tempfile.mkstemp(dir=path, prefix=state_file + ".",
                               suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(
            f,
            **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
            **ir_arrays,
            **prof_arrays,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, state_file))
    fd, tmp = tempfile.mkstemp(dir=path, prefix="session.json.",
                               suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(
            {
                "format_version": FORMAT_VERSION,
                "chain_config": chain_config,
                "targets": targets_map,
                "n_leaves": len(leaves),
                "gen": gen,
                "state_file": state_file,
                "fs": int(fs) if fs else None,
                "custom_irs": ir_meta,
                "noise_profiles": prof_meta,
            },
            f,
            indent=2,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, manifest)  # the commit point
    # Best-effort cleanup of superseded generations, only after the new
    # manifest is durable.
    for name in os.listdir(path):
        if (
            name != state_file
            and name.startswith("state")
            and (name.endswith(".npz") or name.endswith(".tmp"))
        ):
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass


def load_session(path: str):
    """Read a checkpoint -> (chain_config, targets_map, rebuild_state_fn,
    custom_irs, noise_profiles, meta).

    ``rebuild_state_fn(template_state)`` grafts the saved leaves onto a
    freshly built chain's state tree, checking the leaf count and every
    shape, and puts each leaf on its template leaf's device with its dtype;
    a sharded template gives a state sharded as it is.
    ``custom_irs`` maps effect_id -> (ir, fs) (rebuild with
    ``ir_static_overrides`` or the state will not fit); ``noise_profiles``
    maps effect_id -> the learned per-bin floor (rebuild with
    ``profile_static_overrides``; remap with ``remap_profiles`` when the
    rebuild rate differs from ``meta["fs"]``).  ``meta`` is the raw
    manifest dict."""
    with open(os.path.join(path, "session.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta.get('format_version')}")
    # ``state_file`` names the committed generation; the flat layout used
    # the fixed name.
    data = np.load(os.path.join(path, meta.get("state_file", "state.npz")))
    leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    custom_irs = {
        m["effect_id"]: (data[m["key"]], int(m["fs"]))
        for m in meta.get("custom_irs", [])
    }
    noise_profiles = {
        m["effect_id"]: data[m["key"]]
        for m in meta.get("noise_profiles", [])
    }

    def rebuild_state(template_state):
        if hasattr(template_state, "resplit"):
            return template_state.resplit(rebuild_state(template_state.join()))
        t_leaves = flatten_like_jax(template_state)
        if len(t_leaves) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, chain expects {len(t_leaves)}"
            )
        cast = []
        for i, (saved, t) in enumerate(zip(leaves, t_leaves)):
            if tuple(saved.shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint leaf {i} has shape {tuple(saved.shape)}, "
                    f"chain expects {tuple(t.shape)} — the state structure "
                    "changed; rebuild instead of resuming"
                )
            cast.append(torch.from_numpy(saved).to(device=t.device, dtype=t.dtype))
        return unflatten_like_jax(template_state, cast)

    return (meta["chain_config"], meta["targets"], rebuild_state, custom_irs,
            noise_profiles, meta)
