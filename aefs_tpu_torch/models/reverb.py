"""Schroeder/Moorer algorithmic reverb (port of aefs_tpu/models/reverb.py).

Per side (reference reverb.py:208-272): pre-delay -> 4 parallel damped
feedback combs summed -> 2 serial Gardner allpass diffusers -> dry/wet mix
with hard clip.  L/R decorrelate by +-0.3 ms lag jitter; per-comb feedback
g = 10^(-3 L / fs / rt60).  Streaming runs both sides' banks as one
8-comb static-window solve (with a leading slot axis in the pool); file
mode runs the whole-file comb-sums kernel (K2, ops/kernels/comb.py) and
rebuilds the final ring state from its damped tail.  On a mesh with a model
axis (parallel/mesh.py) the streaming bank's ``combs``/``lps`` arrive split
over their comb axis (``ModelShards``): each model device steps its combs
and the per-side partial sums are added on the stream's device.
"""

from __future__ import annotations

import torch

from aefs_tpu_torch.core.params import ParamSpec
from aefs_tpu_torch.models.base import EffectModel, ModelShards, lead, ms_to_samples
from aefs_tpu_torch.ops.ringbuf import (
    allpass_block,
    comb_bank_block,
    comb_bank_block_static,
    comb_bank_file_sums,
    delay_read,
    ring_push,
)
from aefs_tpu_torch.utils.platform import device_scope


class Reverb(EffectModel):
    kind = "reverb"

    PARAMS = {
        "rt60_s": ParamSpec(1.5, 0.1, 10.0, smooth="step", step=0.05),
        "damp": ParamSpec(0.3, 0.0, 0.99, smooth="step", step=0.02),
        "pre_delay_ms": ParamSpec(0.0, 0.0, 100.0, smooth="step_ms", step=2.0),
        "mix_dry": ParamSpec(0.7, 0.0, 2.0),
        "mix_wet": ParamSpec(0.5, 0.0, 2.0),
    }

    def __init__(
        self,
        fs,
        blocksize,
        channels=2,
        comb_times_ms=(29.7, 37.1, 41.1, 43.7),
        allpass_times_ms=(5.0, 1.7),
        allpass_gain=0.6,
        jitter_ms=0.3,
        max_delay_ms=200.0,
        max_pre_delay_ms=100.0,
        file_mode=False,
        file_damp=None,
        **config,
    ):
        super().__init__(fs, blocksize, channels, **config)
        # Baked damping for the whole-file comb solve (file mode only):
        # lets the kernel use its exact truncated-FIR damping at small h.
        self.file_damp = None if file_damp is None else float(file_damp)
        self.ap_gain = float(allpass_gain)
        self.pre_size = max(1, int(fs * float(max_pre_delay_ms) / 1000.0) + 1)

        def lags(times_ms, jitter, scale):
            out = []
            for base in times_ms:
                ms = min(float(base) + jitter * scale, float(max_delay_ms) - 1.0)
                out.append(max(1, int(fs * ms / 1000.0)))
            return out

        j = float(jitter_ms)
        self.comb_lags = [lags(comb_times_ms, +j, 1.0), lags(comb_times_ms, -j, 1.0)]
        self.ap_lags = [lags(allpass_times_ms, +j, 0.2), lags(allpass_times_ms, -j, 0.2)]
        self.comb_lmax = max(max(side) for side in self.comb_lags)
        self.comb_lmin = min(min(side) for side in self.comb_lags)
        self.n_combs = len(comb_times_ms)
        if file_mode and self.comb_lmax >= 2 * self.comb_lmin:
            raise ValueError(
                f"reverb comb_times_ms={tuple(comb_times_ms)} is not "
                f"file-mode renderable: jittered comb lags span "
                f"[{self.comb_lmin}, {self.comb_lmax}] samples at "
                f"fs={fs}, violating max < 2*min required by the "
                f"whole-file comb solver. Keep the longest comb time "
                f"under twice the shortest (jitter_ms={j} included)."
            )
        self._lags_f = torch.tensor(self.comb_lags[0] + self.comb_lags[1],
                                    dtype=torch.float32, device=self.device)
        self._lag_tensors = {}  # (lags, device) -> the lags on that device

    def init_state(self):
        dev = self.device
        return {
            "pre": torch.zeros((2, self.pre_size), device=dev),
            "combs": torch.zeros((2, self.n_combs, self.comb_lmax), device=dev),
            "lps": torch.zeros((2, self.n_combs), device=dev),
            "aps": tuple(
                tuple(torch.zeros((lag,), device=dev) for lag in self.ap_lags[side])
                for side in range(2)
            ),
        }

    def _pre_and_gains(self, state, p, x):
        """Pre-delay per side and the per-comb feedback gains from RT60."""
        pre_d = torch.clamp(ms_to_samples(self.fs, p["pre_delay_ms"]),
                            max=self.pre_size - 1)  # reverb.py:224-225
        pre_out = delay_read(state["pre"], x, lead(pre_d))
        g_all = torch.pow(
            10.0, -3.0 * (self._lags_f / float(self.fs)) / lead(torch.clamp(p["rt60_s"], min=1e-3))
        )
        return pre_out, ring_push(state["pre"], x), g_all

    def process(self, state, p, x):
        pre_out, new_pre, g_all = self._pre_and_gains(state, p, x)
        if isinstance(state["combs"], ModelShards):
            sums, combs, lps = self._comb_bank_model_split(state, p, pre_out, g_all)
            return self._diffuse_and_mix(state, p, x, [sums[..., 0:1, :], sums[..., 1:2, :]],
                                         new_pre, combs, lps)
        b = self.n_combs
        lead_shape = x.shape[:-2]  # the pool's slot axis, if any
        xb = torch.repeat_interleave(pre_out, b, -2)  # (..., 2B, N) side-major
        static_lags = tuple(self.comb_lags[0] + self.comb_lags[1])
        hists = state["combs"].reshape(*lead_shape, 2 * b, -1)
        lps = state["lps"].reshape(*lead_shape, 2 * b)
        y, hists, lps = self._comb_step(hists, lps, xb, static_lags, g_all, lead(p["damp"], 2))
        return self._diffuse_and_mix(
            state, p, x, [y[..., :b, :], y[..., b:, :]], new_pre,
            torch.stack([hists[..., :b, :], hists[..., b:, :]], -3),
            torch.stack([lps[..., :b], lps[..., b:]], -2))

    def _comb_step(self, hists, lps, xb, lags, g, damp):
        if xb.shape[-1] <= self.comb_lmin:
            # Mic-sized blocks: every lag read predates the block.
            return comb_bank_block_static(hists, lps, xb, lags, g, damp)
        return comb_bank_block(hists, lps, xb, self._lag_tensor(lags, xb.device), g, damp,
                               self.comb_lmin)

    def _lag_tensor(self, lags, device):
        """``lags`` as a tensor on ``device``, made at the first long block and
        kept: a step captured as a CUDA graph cannot upload, and the step
        runner's warm-up comes before its capture (core/packing.py)."""
        key = (lags, str(device))
        if key not in self._lag_tensors:
            self._lag_tensors[key] = torch.tensor(list(lags), device=device)
        return self._lag_tensors[key]

    def _comb_bank_model_split(self, state, p, pre_out, g_all):
        """The streaming comb bank over the mesh's model axis: piece j of
        ``combs`` (..., 2, r, Lmax) and ``lps`` (..., 2, r) holds combs
        [j*r, (j+1)*r) of each side on its device, which steps them as the
        whole bank would; the per-side partial sums (..., 2, N) are added
        on ``pre_out``'s device, model shard 0 first.  Returns (sums, combs,
        lps), the state leaves still split."""
        b = self.n_combs
        pieces, lp_pieces = state["combs"].pieces, state["lps"].pieces
        r = b // len(pieces)
        lead_shape = pre_out.shape[:-2]
        sums = None
        new_combs, new_lps = [], []
        for j, (hist, lp) in enumerate(zip(pieces, lp_pieces)):
            dev = hist.device
            combs = range(j * r, (j + 1) * r)
            lags = tuple(self.comb_lags[side][c] for side in range(2) for c in combs)
            with device_scope(dev):  # the part's work with its card current
                # The part's gains, side by side: slices, as a step inside
                # a captured graph cannot upload an index list.
                g = torch.cat([g_all[..., j * r:(j + 1) * r],
                               g_all[..., b + j * r:b + (j + 1) * r]], -1).to(dev)
                xb = torch.repeat_interleave(pre_out.to(dev), r, -2)
                y, h2, l2 = self._comb_step(hist.reshape(*lead_shape, 2 * r, -1),
                                            lp.reshape(*lead_shape, 2 * r), xb, lags, g,
                                            lead(p["damp"], 2).to(dev))
                part = torch.stack([torch.sum(y[..., :r, :], -2),
                                    torch.sum(y[..., r:, :], -2)], -2)
            part = part.to(pre_out.device)
            sums = part if sums is None else sums + part
            new_combs.append(h2.reshape(hist.shape))
            new_lps.append(l2.reshape(lp.shape))
        return (sums, ModelShards(new_combs, state["combs"].axis),
                ModelShards(new_lps, state["lps"].axis))

    def _diffuse_and_mix(self, state, p, x, comb_y, new_pre, combs, lps):
        """Per-side allpass diffusers, dry/wet mix with hard clip
        (reverb.py:243-277), and state assembly.  comb_y: per side a
        (..., K, N) tensor summed over its K axis; combs, lps: the new comb
        bank state leaves."""
        new_aps, wet_sides = [], []
        for side in range(2):
            sig = torch.sum(comb_y[side], -2)  # comb sum (reverb.py:234-241)
            side_aps = []
            for stage, lag in enumerate(self.ap_lags[side]):
                sig, ap_hist = allpass_block(state["aps"][side][stage], sig,
                                             self.ap_gain, lag)
                side_aps.append(ap_hist)
            new_aps.append(tuple(side_aps))
            wet_sides.append(sig)
        wet = torch.stack(wet_sides, -2)
        y = torch.clamp(lead(p["mix_dry"], 2) * x + lead(p["mix_wet"], 2) * wet, -1.0, 1.0)
        new_state = {
            "pre": new_pre,
            "combs": combs,
            "lps": lps,
            "aps": tuple(new_aps),
        }
        return new_state, y

    def process_file(self, state, p, x):
        """Whole-file path: the comb bank runs as one chunked pass through
        the comb-sums kernel (per-side sums plus the damped tail of the
        last three chunks), the allpasses as residue-class scans.  Needs
        fresh reverb state, which file mode guarantees.  x: (2, N), or
        (F, 2, N) for F files (one kernel launch for all of them)."""
        pre_out, new_pre, g_all = self._pre_and_gains(state, p, x)
        b = self.n_combs
        lags = self.comb_lags[0] + self.comb_lags[1]
        side_of = (0,) * b + (1,) * b
        y_msc, d3, c = comb_bank_file_sums(pre_out, lags, g_all, p["damp"],
                                           side_of, 2, h_static=self.file_damp)

        n = x.shape[-1]
        files = x.shape[:-2]
        lmax = self.comb_lmax
        comb_y = [y_msc[..., side, :, :].reshape(*files, -1)[..., :n][..., None, :]
                  for side in range(2)]

        # Final ring state w = x + g*damped over the last ``lmax`` samples,
        # from the damped tail chunks.
        m = y_msc.shape[-2]
        k = min(m, -(-lmax // c) + 1)  # <= 3 since lmax < 2C
        off = m * c - k * c  # padded-coordinate start of the tail window
        d_tail = d3[..., 3 - k :, :, :].transpose(-3, -2).reshape(*files, 2 * b, k * c)
        take = min(n, lmax)
        start = n - take
        d_win = d_tail[..., start - off : n - off]
        x_tail = torch.repeat_interleave(pre_out[..., start:n], b, -2)
        w_win = x_tail + g_all[:, None] * d_win
        if take < lmax:
            w_win = torch.cat([torch.zeros(files + (2 * b, lmax - take), device=x.device),
                               w_win], -1)
        lps_all = d_tail[..., n - 1 - off]

        new_combs = [w_win[..., side * b : (side + 1) * b, :] for side in range(2)]
        new_lps = [lps_all[..., side * b : (side + 1) * b] for side in range(2)]
        return self._diffuse_and_mix(state, p, x, comb_y, new_pre, torch.stack(new_combs, -3),
                                     torch.stack(new_lps, -2))
