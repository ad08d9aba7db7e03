"""Share of the profiled slice in which no kernel, copy or set ran on the
device: 1 - (union of their intervals) / slice."""

UNIT = "%"
LAYER = "device"
MOVES = "realtime_factor"
SOURCE = "device_trace"


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or (not t.kernels and not t.copies):
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
