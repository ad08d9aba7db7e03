"""The real-time factor of the served pipeline, read per layer in the
cells that do not hold it end to end: seconds of sky whose products all
left the output thread over the wall seconds between the first and the
last fast-dump completion in the window (``XEnginePipeline.dump_times``),
as ``realtime_factor`` is taken; in a traced run the profiler records the
card's activity over the window's last 80%."""

UNIT = "x"
LAYER = "served pipeline"
MOVES = "device_peak_gib"
SOURCE = "host_clock"


def read(r):
    return r.rtf
