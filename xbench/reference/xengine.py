"""Plain float64 versions of what one LWA-352 X-engine pipeline computes.

Conventions are the configuration's, as the upstream pipeline states them
(caltech-bifrost-dsp ``corr_block.py``, ``beamform_block.py``,
``cublas_beamform.cu:248-276``, ``corr_subsel_block.py``):

- a packed byte is one complex sample, real part in the high nibble,
  imaginary part in the low nibble, each 4-bit two's complement;
- inputs are ordered ``stand * npol + pol``;
- visibilities ``V[c, i, j] = sum_t x[t, c, i] * conj(x[t, c, j])``;
- beams ``b[c, k, t] = sum_i w[c, k, i] * x[t, c, i]`` (no conjugate),
  beam pairs (2k, 2k+1) the X and Y pols of dual-pol beam k, powers
  [XX, YY, Re(X conj Y), Im(X conj Y)] summed over ``ntime_sum``; VLBI the
  first two single-pol beams;
- gains ``w = amp * exp(2j pi f delay)`` with ``f = (chan0 + c) *
  chan_bw``;
- the channelizer: FIR over ``ntap`` frames of ``L = 2 nchan`` samples
  with the sinc-Hamming prototype, real DFT bins 0..nchan-1, then
  ``clip(round_half_even(v * scale), -8, 7)``.

Every integer sum here is exact in float64 (far below 2**53).
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 bytes -> (real, imag) float64 of the same shape."""
    p = packed.to(torch.int16)
    re = ((p >> 4) & 0xF) - 16 * ((p >> 7) & 1)
    im = (p & 0xF) - 16 * ((p >> 3) & 1)
    return re.to(F64), im.to(F64)


def correlate(re: torch.Tensor, im: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(re, im) [c, t, i] -> (real, imag) [c, i, j] of sum_t x_i conj(x_j)."""
    rt, it = re.transpose(1, 2), im.transpose(1, 2)
    vr = torch.bmm(rt, re) + torch.bmm(it, im)
    vi = torch.bmm(it, re) - torch.bmm(rt, im)
    return vr, vi


def beam_gains(delays_ns: np.ndarray, amps: np.ndarray, nchan: int,
               chan0: int, chan_bw_hz: float, device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 gain planes [c, beam, input] from per-beam delays (ns) and
    amplitudes [beam, input]."""
    f = (chan0 + np.arange(nchan)) * chan_bw_hz
    ph = 2 * np.pi * f[:, None, None] * delays_ns[None] * 1e-9
    g = amps[None] * np.exp(1j * ph)
    return (torch.from_numpy(g.real.copy()).to(device),
            torch.from_numpy(g.imag.copy()).to(device))


def beams(re: torch.Tensor, im: torch.Tensor, gr: torch.Tensor,
          gi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(re, im) [c, t, i] and gains [c, k, i] -> beams [c, k, t]."""
    rt, it = re.transpose(1, 2), im.transpose(1, 2)
    return (torch.bmm(gr, rt) - torch.bmm(gi, it),
            torch.bmm(gr, it) + torch.bmm(gi, rt))


def power(br: torch.Tensor, bi: torch.Tensor, ntime_sum: int
          ) -> torch.Tensor:
    """Beams [c, k, t] -> powers [k/2, t/ntime_sum, c, 4]."""
    c, k, t = br.shape
    nb = t // ntime_sum

    def split(z):
        z = z.reshape(c, k // 2, 2, nb, ntime_sum)
        return z[:, :, 0], z[:, :, 1]

    xr, yr = split(br)
    xi, yi = split(bi)
    out = torch.stack([(xr * xr + xi * xi).sum(-1),
                       (yr * yr + yi * yi).sum(-1),
                       (xr * yr + xi * yi).sum(-1),
                       (xi * yr - xr * yi).sum(-1)], dim=-1)
    return out.permute(1, 2, 0, 3)


def vlbi(br: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
    """Beams [c, k, t] -> the first two beams as [t, c, 2, (re, im)]."""
    return torch.stack([br[:, :2], bi[:, :2]], dim=-1).permute(2, 0, 1, 3)


def pfb_window(nchan: int, ntap: int) -> np.ndarray:
    """The prototype filter the configuration states: sinc over
    [-ntap/2, ntap/2) times a Hamming window, as float32 coefficients
    scaled to sum to ``ntap``; [ntap, 2 nchan]."""
    taps = ntap * 2 * nchan
    t = np.arange(taps) / (2 * nchan) - ntap / 2.0
    coeff = (np.sinc(t) * np.hamming(taps)).astype(np.float32)
    coeff /= coeff.sum() / ntap
    return coeff.reshape(ntap, 2 * nchan)


def channelize_codes(adc: torch.Tensor, window: np.ndarray, nchan: int,
                     ntap: int, scale: float, chunk: int = 176
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """ADC [(nspec + ntap - 1) * 2 nchan, ninput] (history first) -> 4-bit
    codes (re, im) int8 [nspec, nchan, ninput], in float64, ``chunk``
    inputs at a time."""
    L = 2 * nchan
    nframe = adc.shape[0] // L
    nspec = nframe - (ntap - 1)
    ninput = adc.shape[1]
    w = torch.from_numpy(window.astype(np.float64)).to(adc.device)
    out_r = torch.empty((nspec, nchan, ninput), dtype=torch.int8,
                        device=adc.device)
    out_i = torch.empty_like(out_r)
    for i0 in range(0, ninput, chunk):
        fr = adc[:, i0:i0 + chunk].to(F64).reshape(nframe, L, -1)
        fir = fr[0:nspec] * w[0][None, :, None]
        for k in range(1, ntap):
            fir += fr[k:k + nspec] * w[k][None, :, None]
        spec = torch.fft.rfft(fir, dim=1)[:, :nchan] * scale
        out_r[:, :, i0:i0 + chunk] = spec.real.round().clamp(-8, 7).to(
            torch.int8)
        out_i[:, :, i0:i0 + chunk] = spec.imag.round().clamp(-8, 7).to(
            torch.int8)
    return out_r, out_i


def production_baselines(nstand_sel: int, npol: int) -> np.ndarray:
    """The fast subselection: every pol pair of every stand pair (autos
    included) among the first ``nstand_sel`` stands, [nvis, 2, (stand,
    pol)] (corr_subsel_block.py:185: 48 stands, 4704 visibilities)."""
    return np.array([[[s0, p0], [s1, p1]]
                     for s0 in range(nstand_sel)
                     for s1 in range(s0, nstand_sel)
                     for p0 in range(npol) for p1 in range(npol)],
                    dtype=np.int64)


def subsel(vr: torch.Tensor, vi: torch.Tensor, pairs: np.ndarray,
           nchan_sum: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense visibilities [c, n, n] and input pairs [nvis, 2] ->
    channel-summed [c / nchan_sum, nvis] (real, imag)."""
    i0 = torch.from_numpy(pairs[:, 0]).to(vr.device)
    i1 = torch.from_numpy(pairs[:, 1]).to(vr.device)
    c = vr.shape[0]
    sr = vr[:, i0, i1].reshape(c // nchan_sum, nchan_sum, -1).sum(1)
    si = vi[:, i0, i1].reshape(c // nchan_sum, nchan_sum, -1).sum(1)
    return sr, si


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away),
    as float32: the operand rounding of a TF32 tensor-core product."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)
