"""Frozen yardstick: the published peaks of one NVIDIA H100 SXM and the
work of each kernel family per fast window, counted from the shapes alone,
whatever the kernels do.

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the memory rate, and its
operations over the peak rate of their type.  Copied from the port's
``utils/roofline.py`` and made independent of the implementation: the
correlator's planes are counted over every pair i <= j exactly, with no
tile.  Peaks are the data sheet's dense rates at a 700 W power limit.
"""

from __future__ import annotations

import math

#: H100 SXM HBM3 rate, bytes/s
HBM_BYTES_S = 3.35e12
#: H100 SXM dense peaks, operations/s: int8 and bf16 on the tensor cores,
#: FP64 on the tensor cores, float32 outside them
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "fp64": 67e12,
              "fp32": 67e12}


def bound_s(nbyte: float, nop: float, kind: str) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations") for ``nbyte`` bytes moved
    and ``nop`` operations of type ``kind``."""
    t_bytes = nbyte / HBM_BYTES_S
    t_ops = nop / PEAK_OPS_S[kind]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def corr_work(nchan: int, ntime: int, ninput: int) -> tuple:
    """(bytes, operations, type) of correlating one window of ``ntime``
    spectra: the packed 4+4-bit block read once, the two int32 planes of
    the fast accumulator written for every pair i <= j; 4 real
    multiply-adds per sample, channel and pair on the int8 tensor
    cores."""
    npair = ninput * (ninput + 1) // 2
    nbyte = nchan * ntime * ninput + 2 * 4 * nchan * npair
    return nbyte, 8 * nchan * ntime * npair, "int8"


def pfb_work(nspec: int, nchan: int, ninput: int, ntap: int,
             adc_itemsize: int) -> tuple:
    """(bytes, operations, type) of channelizing one window of ``nspec``
    spectra: the ADC block with its (ntap - 1)-frame history read once,
    the packed bytes written once; the FIR's 2 * ntap operations a sample
    and a real FFT's 2.5 log2(L) (the least count for the transform) in
    float32."""
    L = 2 * nchan
    adc_nbyte = (nspec + ntap - 1) * L * ninput * adc_itemsize
    nbyte = adc_nbyte + ninput * nspec * nchan
    nop = nspec * ninput * L * (2 * ntap + 2.5 * math.log2(L))
    return nbyte, nop, "fp32"
