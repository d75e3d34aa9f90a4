"""Effect model registry (port of aefs_tpu/models/__init__.py).

``EFFECT_REGISTRY`` maps the effect types ported so far to their models.
``UNPORTED`` lists the reference's other types: a chain config naming one
of them must fail loudly (``core.chain.build_chain`` raises
``NotImplementedError``) rather than be skipped like a truly unknown type,
because skipping it would render a different chain than the reference.
"""

from aefs_tpu_torch.models.base import EffectModel
from aefs_tpu_torch.models.biquad import BiquadFilter
from aefs_tpu_torch.models.bitcrusher import Bitcrusher
from aefs_tpu_torch.models.chorus import Chorus
from aefs_tpu_torch.models.delay import StereoDelay
from aefs_tpu_torch.models.flanger import Flanger
from aefs_tpu_torch.models.gate import NoiseGate
from aefs_tpu_torch.models.octaver import Octaver
from aefs_tpu_torch.models.phaser import Phaser
from aefs_tpu_torch.models.reverb import Reverb
from aefs_tpu_torch.models.ringmod import RingMod
from aefs_tpu_torch.models.tremolo import Tremolo
from aefs_tpu_torch.models.wah import Wah

EFFECT_REGISTRY = {
    "delay": StereoDelay,
    "reverb": Reverb,
    "gate": NoiseGate,
    "octaver": Octaver,
    "filter": BiquadFilter,
    "chorus": Chorus,
    "flanger": Flanger,
    "tremolo": Tremolo,
    "phaser": Phaser,
    "ringmod": RingMod,
    "bitcrusher": Bitcrusher,
    "wah": Wah,
}

UNPORTED = frozenset({
    "compressor", "limiter", "stereowidth", "spectral", "waveshaper",
    "convreverb", "parallel", "multiband",
})

__all__ = [
    "EffectModel",
    "BiquadFilter",
    "Bitcrusher",
    "Chorus",
    "StereoDelay",
    "Flanger",
    "NoiseGate",
    "Octaver",
    "Phaser",
    "Reverb",
    "RingMod",
    "Tremolo",
    "Wah",
    "EFFECT_REGISTRY",
    "UNPORTED",
]
