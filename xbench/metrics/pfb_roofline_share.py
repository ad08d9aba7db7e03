"""The channelizer kernels' share of their roofline: the frozen bound of
one window's channelization (:func:`xbench.roofline.pfb_work`) times the
windows stepped in the profiled slice, over the summed time of the
kernels whose names match ``PATTERNS`` (``ops/pfb_fused.py`` ->
``csrc/pfb_quantize.cu``)."""

from xbench import roofline

UNIT = "%"
LAYER = "kernel pfb_quantize"
MOVES = "realtime_factor"
SOURCE = "device_trace"
PATTERNS = (r"pfb_",)


def read(r):
    t = r.trace
    if t is None or t.windows <= 0 or not r.fx:
        return None
    ks = t.kernel_s(PATTERNS)
    if ks <= 0:
        return None
    p = r.p
    itemsize = 1 if p.get("adc_dtype") == "int8" else 4
    b, _ = roofline.bound_s(*roofline.pfb_work(
        p["acc_len"], p["nchan"], p["nstand"] * p["npol"], p["pfb_ntap"],
        itemsize))
    return 100.0 * b * t.windows / ks
