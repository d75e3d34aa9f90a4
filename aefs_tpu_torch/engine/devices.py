"""Audio device selection helper (parity with ``pick_devices``,
core.py:12-53 — exported by the reference package but never called by the
app; provided for API completeness).

Prefers a JACK input/output pair matched by name hints, falls back to the
PulseAudio endpoint, else lets PortAudio use OS defaults.  Gated on
``sounddevice`` availability exactly like the reference (core.py:6-9).
"""

from __future__ import annotations

try:
    import sounddevice as sd
except (ImportError, OSError):
    sd = None


def pick_devices(ch_in=1, ch_out=2, in_hint=("usb", "mic"), out_hint=("system",)):
    """Return (input_index, output_index) or (None, None) for OS defaults."""
    if sd is None:
        return None, None
    try:
        apis = sd.query_hostapis()
    except Exception:
        return None, None
    jack_id = next((i for i, a in enumerate(apis) if "JACK" in a["name"]), None)
    pulse_id = next((i for i, a in enumerate(apis) if "Pulse" in a["name"]), None)
    devices = sd.query_devices()

    def find_on_api(api_id, want_in, want_out, tokens):
        tokens = tuple(t.lower() for t in tokens)
        for i, d in enumerate(devices):
            if d["hostapi"] != api_id:
                continue
            name = d["name"].lower()
            if not all(tok in name for tok in tokens):
                continue
            ok_in = (not want_in) or d["max_input_channels"] >= ch_in
            ok_out = (not want_out) or d["max_output_channels"] >= ch_out
            if ok_in and ok_out:
                return i
        return None

    if jack_id is not None:
        in_idx = find_on_api(jack_id, True, False, in_hint)
        out_idx = find_on_api(jack_id, False, True, out_hint)
        if in_idx is not None and out_idx is not None:
            return in_idx, out_idx

    if pulse_id is not None:
        pulse_idx = next(
            (i for i, d in enumerate(devices) if d["hostapi"] == pulse_id), None
        )
        if pulse_idx is not None:
            return pulse_idx, pulse_idx

    return None, None


def list_devices(ch_in=1, ch_out=2):
    """Enumerate PortAudio devices for the UI's input/output pickers
    (reference wishlist todo:2 "poder elegir input y output").  Returns
    [] in server mode (no sounddevice / no audio hardware)."""
    if sd is None:
        return []
    try:
        devices = sd.query_devices()
    except Exception:
        return []
    out = []
    for i, d in enumerate(devices):
        out.append({
            "index": i,
            "name": d["name"],
            "max_input_channels": int(d["max_input_channels"]),
            "max_output_channels": int(d["max_output_channels"]),
            "usable_input": d["max_input_channels"] >= ch_in,
            "usable_output": d["max_output_channels"] >= ch_out,
        })
    return out
