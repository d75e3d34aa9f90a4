"""STFT framing, overlap-add and partitioned FFT convolution (port of
aefs_tpu/ops/fftops.py), shared by the spectral gate and the convolution
reverb.

The transforms are ``torch.fft`` (cuFFT on the card, pocketfft on the
CPU), as the JAX package's are ``jnp.fft`` outside any Pallas kernel.
Unlike the JAX functions, these take leading batch axes (the convolution
reverb's channels) instead of being vmapped.  Complex values exist only
inside a call: the carried spectra are real/imag-split float32, the state
layout the JAX package uses.
"""

from __future__ import annotations

import numpy as np
import torch

from aefs_tpu_torch.utils.platform import device_scope


def hann_window(n_fft: int, device="cpu"):
    """Symmetric Hann window, identical to np.hanning."""
    return torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(device)


def rfft_last(x):
    return torch.fft.rfft(x, dim=-1)


def irfft_last(spec):
    """Inverse of ``rfft_last``, length 2*(bins-1)."""
    return torch.fft.irfft(spec, dim=-1)


def frame_signal(tail, x, n_fft: int, hop: int):
    """Overlapping analysis frames of ``tail ++ x`` along the last axis.

    tail: (..., n_fft - hop) carried samples; x: (..., N), N a multiple of
    ``hop``.  Returns (frames (..., N // hop, n_fft), new_tail): frame i
    covers samples [i*hop, i*hop + n_fft) of the joined stream."""
    n = x.shape[-1]
    stream = torch.cat([tail, x], -1)
    return stream.unfold(-1, n_fft, hop), stream[..., n:]


def overlap_add(frames, tail, hop: int):
    """50%-overlap-add synthesis.  frames: (..., k, 2*hop); tail: (..., hop)
    the previous frame's second half.  Returns (y (..., k*hop), new_tail)."""
    k = frames.shape[-2]
    halves = torch.cat([tail[..., None, :], frames[..., :-1, hop:]], -2)
    return ((frames[..., :hop] + halves).reshape(*frames.shape[:-2], k * hop),
            frames[..., -1, hop:])


def partitioned_fft_conv(spec_hist, in_tail, x, ir_spectra, hop: int):
    """Uniformly-partitioned FFT convolution (overlap-save with a
    frequency-domain delay line): per hop, the input frame's spectrum joins
    a P-deep history and the output is sum_q X[t-q] * H[q].

    spec_hist: (..., 2, P-1, hop+1) float32, previous input-frame spectra
      (real, imag), chronological (newest last).
    in_tail: (..., hop) previous input hop.
    x: (..., N), N a multiple of ``hop``.
    ir_spectra: (..., P, hop+1) complex64 partition spectra (static).

    Returns (y (..., N), new_spec_hist, new_in_tail)."""
    p = ir_spectra.shape[-2]
    n = x.shape[-1]
    k = n // hop

    frames, new_in_tail = frame_signal(in_tail, x, 2 * hop, hop)
    specs = rfft_last(frames)  # (..., k, hop+1)
    hist = torch.complex(spec_hist[..., 0, :, :], spec_hist[..., 1, :, :])
    full = torch.cat([hist, specs], -2)  # (..., P-1+k, hop+1)
    if k == 1:
        # Streaming (one hop per block): the window is `full` reversed.
        windows = torch.flip(full, [-2]).unsqueeze(-3)  # (..., 1, P, hop+1)
    else:
        # Output hop j reads X_{j-q} = full[P-1+j-q], q = 0..P-1.
        base = (torch.arange(k, device=x.device)[:, None]
                + (p - 1 - torch.arange(p, device=x.device))[None, :])
        windows = full[..., base, :]  # (..., k, P, hop+1)
    y_spec = torch.sum(windows * ir_spectra.unsqueeze(-3), -2)  # (..., k, hop+1)

    # Overlap-save: the second half of each output frame is valid.
    y = irfft_last(y_spec)[..., hop:].reshape(*x.shape[:-1], n)
    new_hist = full[..., k:, :]
    return y, torch.stack([new_hist.real, new_hist.imag], -3), new_in_tail


def partitioned_fft_conv_split(hist_parts, in_tail, x, ir_spectra, hop: int, ir_on):
    """``partitioned_fft_conv`` with the history split over a mesh's model
    axis: ``hist_parts[j]`` (..., 2, r, hop+1) holds history partitions
    [j*r, (j+1)*r) (chronological) on its own device, and ``ir_on(device,
    lo, hi)`` gives ``ir_spectra[..., lo:hi, :]`` there.

    Streaming (one hop per block): each part multiplies its frames by their
    partition spectra on its device; the partial spectra are added on x's
    device, model shard 0 first, then the new frame's term.  The history
    shifts by one partition: each part takes the next part's oldest frame,
    the last part the new frame.  Longer blocks join the history, run
    ``partitioned_fft_conv`` and split it again.

    Returns (y (..., N), the new parts, new_in_tail)."""
    p = ir_spectra.shape[-2]
    r = hist_parts[0].shape[-2]
    n = x.shape[-1]
    if n // hop != 1:
        hist = torch.cat([h.to(x.device) for h in hist_parts], -2)
        y, new_hist, new_in_tail = partitioned_fft_conv(hist, in_tail, x, ir_spectra, hop)
        return y, [new_hist[..., j * r:(j + 1) * r, :].contiguous().to(h.device)
                   for j, h in enumerate(hist_parts)], new_in_tail

    frames, new_in_tail = frame_signal(in_tail, x, 2 * hop, hop)
    spec = rfft_last(frames)  # (..., 1, hop+1)
    y_spec = None
    for j, part in enumerate(hist_parts):
        # Frame j*r + t of the history meets partition p-1-(j*r + t): the
        # part reversed meets partitions [p-(j+1)r, p-jr) in order.
        with device_scope(part.device):  # the part's work with its card current
            window = torch.flip(torch.complex(part[..., 0, :, :], part[..., 1, :, :]), [-2])
            acc = torch.sum(window * ir_on(part.device, p - (j + 1) * r, p - j * r), -2)
        acc = acc.to(x.device)
        y_spec = acc if y_spec is None else y_spec + acc
    y_spec = y_spec[..., None, :] + spec * ir_spectra[..., 0:1, :]
    y = irfft_last(y_spec)[..., hop:].reshape(*x.shape[:-1], n)
    nxt = [part[..., 0:1, :] for part in hist_parts[1:]] + [
        torch.stack([spec.real, spec.imag], -3)]
    new_parts = [torch.cat([part[..., 1:, :], nx.to(part.device)], -2)
                 for part, nx in zip(hist_parts, nxt)]
    return y, new_parts, new_in_tail


def partition_ir(ir, hop: int):
    """Split an impulse response into rfft'd partitions for
    ``partitioned_fft_conv``: partition q covers ir[q*hop:(q+1)*hop],
    zero-padded to 2*hop.  Returns (2, P, hop+1) float32 (real, imag)."""
    ir = np.asarray(ir, np.float32)
    p = max(1, -(-len(ir) // hop))
    padded = np.zeros((p, 2 * hop), np.float32)
    for q in range(p):
        part = ir[q * hop : (q + 1) * hop]
        padded[q, : len(part)] = part
    spec = np.fft.rfft(padded, axis=-1)
    return np.stack([spec.real, spec.imag]).astype(np.float32)
