"""Effect model registry (port of aefs_tpu/models/__init__.py).

``EFFECT_REGISTRY`` maps every effect type of the JAX package to its
model.  ``multiband`` is no class: ``core.chain.build_chain`` expands it
onto the parallel container (core/multiband.py).
"""

from aefs_tpu_torch.models.base import EffectModel
from aefs_tpu_torch.models.biquad import BiquadFilter
from aefs_tpu_torch.models.bitcrusher import Bitcrusher
from aefs_tpu_torch.models.chorus import Chorus
from aefs_tpu_torch.models.compressor import Compressor
from aefs_tpu_torch.models.convreverb import ConvReverb, synthetic_ir
from aefs_tpu_torch.models.delay import StereoDelay
from aefs_tpu_torch.models.flanger import Flanger
from aefs_tpu_torch.models.gate import NoiseGate
from aefs_tpu_torch.models.limiter import Limiter
from aefs_tpu_torch.models.octaver import Octaver
from aefs_tpu_torch.models.parallel_chain import ParallelChains
from aefs_tpu_torch.models.phaser import Phaser
from aefs_tpu_torch.models.reverb import Reverb
from aefs_tpu_torch.models.ringmod import RingMod
from aefs_tpu_torch.models.spectral import SpectralFilter
from aefs_tpu_torch.models.stereowidth import StereoWidth
from aefs_tpu_torch.models.tremolo import Tremolo
from aefs_tpu_torch.models.wah import Wah
from aefs_tpu_torch.models.waveshaper import Waveshaper

EFFECT_REGISTRY = {
    "delay": StereoDelay,
    "reverb": Reverb,
    "gate": NoiseGate,
    "compressor": Compressor,
    "limiter": Limiter,
    "chorus": Chorus,
    "flanger": Flanger,
    "tremolo": Tremolo,
    "phaser": Phaser,
    "ringmod": RingMod,
    "bitcrusher": Bitcrusher,
    "wah": Wah,
    "stereowidth": StereoWidth,
    "spectral": SpectralFilter,
    "octaver": Octaver,
    "filter": BiquadFilter,
    "waveshaper": Waveshaper,
    "convreverb": ConvReverb,
    "parallel": ParallelChains,
}

__all__ = [
    "EffectModel",
    "BiquadFilter",
    "Bitcrusher",
    "Chorus",
    "Compressor",
    "StereoDelay",
    "Flanger",
    "Limiter",
    "NoiseGate",
    "Octaver",
    "Phaser",
    "Reverb",
    "RingMod",
    "SpectralFilter",
    "StereoWidth",
    "Tremolo",
    "Wah",
    "Waveshaper",
    "ConvReverb",
    "ParallelChains",
    "synthetic_ir",
    "EFFECT_REGISTRY",
]
