"""Multi-beam voltage beamforming + integrated power beams.

Port of ``caltech_bifrost_dsp_tpu/ops/beamform.py`` (plain functions) and
of ``ops/pallas/beamform_fused.py::beamform_products_pallas``
(:func:`beamform_products`, kernel 2).

Conventions (reference: cublas_beamform.cu:248-276): the beamform product
applies no conjugation,

    bf[c, b, t] = sum_i  w[c, b, i] * x[t, c, i],

beam pairs (2b, 2b+1) are the X/Y polarizations of dual-pol beam b, and
the power stage integrates ``ntime_sum`` samples into [XX, YY, Re(XY*),
Im(XY*)].  The plain path contracts in float64, so it is a truth for the
kernel's fp32 sums and no TF32 mode applies.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .correlate import chan_major
from .kernels import _build
from ..utils.codec import unpack


#: ``csrc/beamform_products.cu``: inputs per staged chunk, beam rows of a
#: gain tile and bf16 terms of a float32 gain (hi + mid + lo, exact)
SPLIT_KC, SPLIT_BEAMS, SPLIT_TERMS = 32, 32, 3


def split_shape(nchan: int, ninput: int) -> tuple[int, int, int, int, int]:
    """Shape of the kernel's split-gain scratch: int32 words
    [nchan, ceil(ninput / 32), term, beam 32, 32], each the bf16 term of
    Gr in the low half and of Gi in the high half."""
    return (nchan, -(-ninput // SPLIT_KC), SPLIT_TERMS, SPLIT_BEAMS,
            SPLIT_KC)


def split_gains_ref(gains: "BeamGains") -> torch.Tensor:
    """Plain version of the kernel's gain prepass: float32 gains as three
    bf16 terms hi = bf16(g), mid = bf16(g - hi), lo = bf16(g - hi - mid)
    (their sum is g exactly), packed as int32 words in
    :func:`split_shape`'s layout."""
    nchan, nbeam, ninput = gains.real.shape
    shape = split_shape(nchan, ninput)
    words = torch.zeros(shape, dtype=torch.int32, device=gains.real.device)
    pad = shape[1] * SPLIT_KC - ninput
    halves = []
    for plane in gains:
        rest = torch.nn.functional.pad(plane.to(torch.float32), (0, pad))
        terms = []
        for _ in range(SPLIT_TERMS):
            term = rest.to(torch.bfloat16)
            terms.append(term.view(torch.int16).to(torch.int32) & 0xFFFF)
            rest = rest - term.to(torch.float32)
        halves.append(torch.stack(terms, 1))          # [c, term, b, i]
    both = halves[0] | (halves[1] << 16)
    both = both.reshape(nchan, SPLIT_TERMS, nbeam, shape[1], SPLIT_KC)
    words[:, :, :, :nbeam] = both.permute(0, 3, 1, 2, 4)
    return words


class BeamGains(NamedTuple):
    """Complex gains as f32 planes [nchan, nbeam, ninput]."""
    real: torch.Tensor
    imag: torch.Tensor

    @classmethod
    def from_complex(cls, g, device=None) -> "BeamGains":
        g = np.asarray(g)
        return cls(torch.as_tensor(np.real(g), dtype=torch.float32,
                                   device=device),
                   torch.as_tensor(np.imag(g), dtype=torch.float32,
                                   device=device))


class BeamVoltages(NamedTuple):
    """Beams as f32 planes [nchan, nbeam, ntime]."""
    real: torch.Tensor
    imag: torch.Tensor


def _beams_chan_major(xc: torch.Tensor, gains: BeamGains) -> BeamVoltages:
    """float64 beams [nchan, nbeam, ntime] from a chan-major packed view."""
    xr, xi = unpack(xc)
    xr = xr.to(torch.float64).transpose(1, 2)       # [c, i, t]
    xi = xi.to(torch.float64).transpose(1, 2)
    gr = gains.real.to(torch.float64)               # [c, b, i]
    gi = gains.imag.to(torch.float64)
    br = torch.bmm(gr, xr) - torch.bmm(gi, xi)
    bi = torch.bmm(gr, xi) + torch.bmm(gi, xr)
    return BeamVoltages(br, bi)


def beamform_gulp(packed: torch.Tensor, gains: BeamGains) -> BeamVoltages:
    """Form voltage beams for one gulp: packed uint8 [ntime, nchan, ninput]
    -> f32 BeamVoltages [nchan, nbeam, ntime]."""
    bv = _beams_chan_major(chan_major(packed, "tci"), gains)
    return BeamVoltages(bv.real.to(torch.float32), bv.imag.to(torch.float32))


def beam_power_sum(bf: BeamVoltages, ntime_sum: int) -> torch.Tensor:
    """Integrated dual-pol beam powers [nbeam//2, ntime//ntime_sum, nchan, 4]
    with the last axis [XX, YY, Re(X conj(Y)), Im(X conj(Y))]."""
    nchan, nbeam, ntime = bf.real.shape
    if nbeam % 2 or ntime % ntime_sum:
        raise ValueError("nbeam must be even and ntime a multiple of "
                         "ntime_sum")
    nblock = ntime // ntime_sum

    def split(z):
        z = z.reshape(nchan, nbeam // 2, 2, nblock, ntime_sum)
        return z[:, :, 0], z[:, :, 1]

    xr, yr = split(bf.real)
    xi, yi = split(bf.imag)
    xx = (xr * xr + xi * xi).sum(-1)
    yy = (yr * yr + yi * yi).sum(-1)
    xy_r = (xr * yr + xi * yi).sum(-1)
    xy_i = (xi * yr - xr * yi).sum(-1)
    out = torch.stack([xx, yy, xy_r, xy_i], dim=-1)   # [c, B, nblock, 4]
    return out.permute(1, 2, 0, 3).contiguous()        # [B, nblock, c, 4]


def beam_power_single(bf: BeamVoltages, beam: int, ntime_sum: int
                      ) -> torch.Tensor:
    """Power integration for one dual-pol beam -> [ntime//ntime_sum,
    nchan, 4]."""
    sel = BeamVoltages(bf.real[:, 2 * beam:2 * beam + 2],
                       bf.imag[:, 2 * beam:2 * beam + 2])
    return beam_power_sum(sel, ntime_sum)[0]


def vlbi_voltage_select(bf: BeamVoltages, nbeam_out: int = 2
                        ) -> torch.Tensor:
    """The first ``nbeam_out`` single-pol beams as [ntime, nchan,
    nbeam_out, 2 (re, im)]."""
    z = torch.stack([bf.real[:, :nbeam_out], bf.imag[:, :nbeam_out]],
                    dim=-1)                            # [c, b, t, 2]
    return z.permute(2, 0, 1, 3).contiguous()          # [t, c, b, 2]


def delays_to_gains(freqs_hz, delays_ns, amps, cal_gains,
                    device=None) -> BeamGains:
    """``gains = amps * exp(2j pi f tau) * cal`` (reference:
    beamform_block.py:343-349) -> BeamGains planes [nchan, nbeam, ninput]."""
    freqs_hz = np.asarray(freqs_hz, dtype=np.float64)
    phases = np.exp(1j * 2 * np.pi * freqs_hz[:, None, None]
                    * np.asarray(delays_ns)[None] * 1e-9)
    g = np.asarray(amps)[None] * phases * np.asarray(cal_gains)
    return BeamGains.from_complex(g.astype(np.complex64), device=device)


def beamform_products_ref(xc: torch.Tensor, gains: BeamGains,
                          ntime_sum: int, want_power: bool = True,
                          want_vlbi: bool = True):
    """Plain version of :func:`beamform_products` on a chan-major view:
    float64 beams, power and VLBI rounded to f32 at the end."""
    bv = _beams_chan_major(xc, gains)
    power = (beam_power_sum(bv, ntime_sum).to(torch.float32)
             if want_power else None)
    vlbi = (vlbi_voltage_select(bv).to(torch.float32)
            if want_vlbi else None)
    return power, vlbi


def beamform_products(packed: torch.Tensor, gains: BeamGains,
                      ntime_sum: int, want_power: bool = True,
                      want_vlbi: bool = True, layout: str = "tci"):
    """Fused beam products for one gulp (kernel 2).

    Args:
      packed: uint8 [ntime, nchan, ninput] (``layout="tci"``) or
        [nchan, ntime, ninput|padded] (``layout="cti"``; pad lanes are
        never read).
      gains: f32 planes [nchan, nbeam, ninput].
      ntime_sum: power integration length.

    Returns:
      (power f32 [nbeam//2, ntime//ntime_sum, nchan, 4] or None,
       vlbi f32 [ntime, nchan, 2, 2] or None).
    CPU tensors take :func:`beamform_products_ref`; CUDA tensors launch
    the kernel, which writes only these products.  The kernel contracts
    on the bf16 tensor cores from an explicit three-term bf16 split of the
    float32 gains (exact for finite gains of ordinary size, about 1e-30 <
    |g| < 3e38) made anew on every call, so gains changed in place, as by
    a ``load_gains`` command, take effect at the next call.
    """
    if not (want_power or want_vlbi):
        return None, None
    nchan, nbeam, ninput = gains.real.shape
    xc = chan_major(packed, layout, ninput)
    dev = _build.device_of(xc, *gains)
    if dev.type == "cpu":
        return beamform_products_ref(xc, gains, ntime_sum, want_power,
                                     want_vlbi)
    ntime = xc.shape[1]
    if packed.dtype != torch.uint8 or xc.stride(2) != 1:
        raise ValueError("packed must be uint8 with a contiguous input axis")
    if xc.shape[0] != nchan:
        raise ValueError("packed and gains disagree on nchan")
    if nbeam % 2 or nbeam > 32 or ntime_sum > 96 or ntime % ntime_sum:
        raise ValueError("the kernel takes an even nbeam <= 32 and "
                         "ntime_sum <= 96 dividing ntime")
    if (gains.imag.shape != gains.real.shape
            or any(g.dtype != torch.float32 for g in gains)):
        raise ValueError("gain planes must be float32 of one shape")
    _build.require_contiguous(*gains)
    power = vlbi = None
    if want_power:
        power = torch.empty((nbeam // 2, ntime // ntime_sum, nchan, 4),
                            dtype=torch.float32, device=dev)
    if want_vlbi:
        vlbi = torch.empty((ntime, nchan, 2, 2), dtype=torch.float32,
                           device=dev)
    gsplit = torch.empty(split_shape(nchan, ninput), dtype=torch.int32,
                         device=dev)
    _build.launch("cbd_beamform_products", dev, xc.data_ptr(), xc.stride(0),
                  xc.stride(1), nchan, ntime, ninput, gains.real.data_ptr(),
                  gains.imag.data_ptr(), nbeam, ntime_sum, gsplit.data_ptr(),
                  gsplit.numel(),
                  None if power is None else power.data_ptr(),
                  None if vlbi is None else vlbi.data_ptr())
    beamform_products.launches += 1
    return power, vlbi


#: kernel launches made by :func:`beamform_products` in this process
beamform_products.launches = 0
