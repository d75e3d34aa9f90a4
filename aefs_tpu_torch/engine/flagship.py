"""The flagship chain: gate -> octaver (-12 st) -> biquad low-pass ->
stereo delay -> Schroeder reverb, the repo's main path.

The port's own copy of the JAX package's driver config (a test pins the
two equal), so that the port's scripts never import the JAX side.
"""

FLAGSHIP = [
    {"effect_id": "g", "type": "gate",
     "params": {"threshold_db": -45, "attack_ms": 5, "release_ms": 100}},
    {"effect_id": "o", "type": "octaver", "params": {"semitones": -12, "mix": 0.4}},
    {"effect_id": "f", "type": "filter",
     "params": {"filter_type": 0, "cutoff_hz": 4000, "q": 0.8}},
    {"effect_id": "d", "type": "delay",
     "params": {"delay_ms": 375, "feedback": 0.2, "mix_dry": 1.0,
                "mix_wet": 0.6, "offset_ms": 10}},
    {"effect_id": "r", "type": "reverb",
     "params": {"rt60_s": 2.1, "damp": 0.05, "pre_delay_ms": 0,
                "mix_dry": 0.8, "mix_wet": 0.4}},
]
