"""The correlator kernels' share of their roofline: the frozen bound of
one window's correlation (:func:`xbench.roofline.corr_work`) times the
windows stepped in the profiled slice, over the summed time of the
kernels whose names match ``PATTERNS`` (``ops/corr_acc.py`` ->
``csrc/corr_acc.cu``: the unpack prepass and the contraction; the other
correlator schedules' kernels)."""

from xbench import roofline

UNIT = "%"
LAYER = "kernel corr_acc"
MOVES = "device_peak_gib"
SOURCE = "device_trace"
PATTERNS = (r"corr_(acc|triu|rows|blk)", r"unpack_planes")


def read(r):
    t = r.trace
    if t is None or t.windows <= 0:
        return None
    ks = t.kernel_s(PATTERNS)
    if ks <= 0:
        return None
    p = r.p
    b, _ = roofline.bound_s(*roofline.corr_work(
        p["nchan"], p["acc_len"], p["nstand"] * p["npol"]))
    return 100.0 * b * t.windows / ks
