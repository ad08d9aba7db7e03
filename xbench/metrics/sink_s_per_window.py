"""Seconds the output thread spent in the sinks' calls (for the fast
sinks ``send_subsel``, ``send_powers``, ``send_voltages``: encode,
``sendto``, and the deployment caps' sleeps) per fast window, from the
harness's timing proxies around each sink's call (``output.<method>``
spans, one sink module each), over the calls that began inside the
window."""

UNIT = "s"
LAYER = "sinks"
MOVES = "device_peak_gib"
SOURCE = "program_span"


def read(r):
    spans = [s for s in r.spans if s[0].startswith("output.")
             and r.t0_ns <= s[1] < r.t1_ns]
    windows = {s[3] for s in spans}
    if not windows:
        return None
    return sum(s[2] - s[1] for s in spans) / 1e9 / len(windows)
