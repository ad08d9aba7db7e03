"""Device milliseconds of all kernels, whatever their names, per fast
window stepped in the profiled slice."""

UNIT = "ms"
LAYER = "model step"
MOVES = "realtime_factor"
SOURCE = "device_trace"


def read(r):
    t = r.trace
    if t is None or t.windows <= 0:
        return None
    ks = t.kernel_s()
    return 1e3 * ks / t.windows if ks > 0 else None
