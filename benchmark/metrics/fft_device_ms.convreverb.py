"""Device milliseconds of the FFTs in the traced upload: the convolution
reverb's whole-file convolution (the forward transform of the 2 channels
at nfft = 2^20 as a half-length complex transform, cuFFT's post-process
and PyTorch's Hermitian fill of the full spectrum, then the inverse), the
rfft of the end-of-file delay line's 29 frames of 8,192, and the front's
plot analysis (``utils/analysis.py``, two rffts of 16,384, ~0.016 ms),
which is included.  The names, as the card's trace of this cell shows
them (NVIDIA H100, torch 2.11.0+cu128): cuFFT's ``regular_fft_factor<1024u,
...>`` and ``<512u, ...>``, ``vector_fft_symm_r2c<16384u, ...>`` and
``<8192u, ...>``, ``postprocess_kernel<float, ...>``, and PyTorch's
``at::native::_fft_conjugate_copy_kernel<...>``."""

LAYER = "effects (models/convreverb.py, ops/fftops.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "upload_x_realtime"

from benchmark import tracing

NAMES = ("regular_fft_factor", "vector_fft_symm_r2c", "postprocess_kernel",
         "_fft_conjugate_copy_kernel")


def read(obs):
    tr = obs.get("trace")
    if tr is None:
        return None
    sec, n = tracing.kernel_time(tr, NAMES)
    return 1000.0 * sec if n else None
