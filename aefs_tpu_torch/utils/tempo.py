"""Tempo helpers: BPM-synced delay times (reference wishlist, todo:2).

``delay_ms_for(bpm, division)`` converts a tempo and a note division into
the delay time to feed ``update_param(id, "delay_ms", ...)``; divisions
follow the usual convention (1 = quarter note, 0.5 = eighth, 1.5 = dotted
quarter, 2/3 = quarter triplet...).
"""

from __future__ import annotations

NOTE_DIVISIONS = {
    "1/1": 4.0,
    "1/2": 2.0,
    "1/4": 1.0,
    "1/8": 0.5,
    "1/16": 0.25,
    "1/2.": 3.0,
    "1/4.": 1.5,
    "1/8.": 0.75,
    "1/16.": 0.375,
    "1/2T": 4.0 / 3.0,
    "1/4T": 2.0 / 3.0,
    "1/8T": 1.0 / 3.0,
    "1/16T": 1.0 / 6.0,
}


def lfo_rate_hz_for(bpm: float, division=1.0) -> float:
    """LFO rate in Hz for one cycle per ``division`` beats at ``bpm`` —
    the modulation-family analogue of ``delay_ms_for`` (tremolo, chorus,
    flanger, phaser, wah ``rate_hz``)."""
    return 1000.0 / delay_ms_for(bpm, division)


def delay_ms_for(bpm: float, division=1.0) -> float:
    """Delay time in ms for one ``division`` beats at ``bpm``."""
    if isinstance(division, str):
        if division not in NOTE_DIVISIONS:
            raise ValueError(
                f"unknown division {division!r}; valid names: "
                + ", ".join(sorted(NOTE_DIVISIONS))
            )
        division = NOTE_DIVISIONS[division]
    if bpm <= 0:
        raise ValueError("bpm must be positive")
    return 60000.0 / float(bpm) * float(division)
