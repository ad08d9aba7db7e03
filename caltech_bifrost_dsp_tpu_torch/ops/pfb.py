"""Polyphase filterbank channelizer and 4-bit requantizer (port of
``caltech_bifrost_dsp_tpu/ops/pfb.py``, the parts the FX path and the
offline upchannelizer run).

    raw ADC [ntime, ninput] -> FIR over ntap frames of L = 2*nchan samples
        -> real DFT, bins 0..nchan-1 -> clip(round(v * scale), -8, 7)
        -> packed 4+4-bit bytes [ninput, nspec, nchan]   (input-major)

The numpy helpers (window, DFT tables, factor choice, the numpy
reference) return the JAX module's arrays bit for bit.  The plain torch
versions compute in float64 from the same float32 tables, so on a CPU
tensor they are the reference the CUDA kernels
(:mod:`.pfb_fused`, ``kernels/csrc/pfb_quantize.cu`` and ``pfb_fft.cu``)
are held against.

The JAX package has two spectral transforms (``cfg.pfb_fft_impl``
"fft" and "matmul") and two channelizer engines; all compute the same
function, bins 0..nchan-1 of the real DFT of each FIR frame.  The port
has one channelizer for all of them: :func:`channelize_pack_imajor`.

The complex-dtype :func:`pfb_channelize`, :func:`pfb_channelize_planes`,
:func:`quantize_4bit_planes` and :func:`quantize_4bit` are plain functions
that nothing on the port's paths calls (its ``fx_step`` takes both
transforms through the one channelizer); they stand beside the JAX
functions of those names.

:func:`upchannelize` (the offline pipelines' fine channelizer) runs no
kernel of the port's: the JAX package computes it outside any Pallas
kernel, with ``jnp.fft.fft`` or two float32 matrix products.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..utils.codec import pack, unpack


def pfb_window(nchan: int, ntap: int, kind: str = "hamming") -> np.ndarray:
    """Standard sinc-windowed PFB prototype filter, [ntap, 2*nchan] f32.

    ``sinc`` spans [-ntap/2, ntap/2) so each branch applies one sinc lobe;
    normalized so the filter sums to 1 per polyphase branch on average.
    """
    taps = ntap * 2 * nchan
    t = np.arange(taps) / (2 * nchan) - ntap / 2.0
    sinc = np.sinc(t)
    if kind == "hamming":
        win = np.hamming(taps)
    elif kind == "hanning":
        win = np.hanning(taps)
    elif kind == "boxcar":
        win = np.ones(taps)
    else:
        raise ValueError(f"unknown window kind {kind!r}")
    coeff = (sinc * win).astype(np.float32)
    coeff /= coeff.sum() / ntap
    return coeff.reshape(ntap, 2 * nchan)


def required_ntime(nspec: int, nchan: int, ntap: int) -> int:
    """ADC samples needed to produce ``nspec`` spectra."""
    return (nspec + ntap - 1) * 2 * nchan


def rdft_matrices(nchan: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-input DFT as two f32 matrices [2*nchan, nchan]:
    X[k] = sum_n x[n] (cos - i sin)(2 pi n k / 2 nchan), k < nchan."""
    L = 2 * nchan
    n = np.arange(L)[:, None]
    k = np.arange(nchan)[None, :]
    ang = 2 * np.pi * n * k / L
    return (np.cos(ang).astype(np.float32),
            -np.sin(ang).astype(np.float32))


def _dft_factors(L: int) -> tuple[int, int] | None:
    """(L1, L2) with L = L1*L2 for the two-stage factored DFT, factors
    near sqrt(L), L1 (outer) >= L2 (inner); None when the direct
    [L, nchan] product is used (L < 2048, or no factor pair with
    L2 >= 32 and L1 >= 64)."""
    if L < 2048:
        return None
    best = None
    f = int(np.sqrt(L))
    for d in range(f, 1, -1):
        if L % d == 0:
            best = (L // d, d)
            break
    if best is None or best[1] < 32 or best[0] < 64:
        return None
    return best


@functools.lru_cache(maxsize=8)
def _rdft_factored_tables(nchan: int):
    """Constant tables for the factored real-input DFT (f32):
    inner-DFT [L2, L2] cos/-sin, twiddle [L1, L2] cos/-sin, outer-DFT
    [L1, L1//2] cos/sin.  With n = n1 + L1*n2 and k = k2 + L2*k1,
    X[k] = sum_n1 W_L1^{n1 k1} (W_L^{n1 k2} sum_n2 x[n1+L1 n2]
    W_L2^{n2 k2}); only k < nchan = L/2 is needed, so k1 < L1/2."""
    L = 2 * nchan
    L1, L2 = _dft_factors(L)
    n2 = np.arange(L2)[:, None]
    k2 = np.arange(L2)[None, :]
    ang2 = 2 * np.pi * n2 * k2 / L2
    c2, s2 = np.cos(ang2), -np.sin(ang2)
    n1 = np.arange(L1)[:, None]
    angt = 2 * np.pi * n1 * k2 / L
    twr, twi = np.cos(angt), -np.sin(angt)
    k1 = np.arange(L1 // 2)[None, :]
    ang1 = 2 * np.pi * n1 * k1 / L1
    c1, s1 = np.cos(ang1), np.sin(ang1)
    return tuple(m.astype(np.float32)
                 for m in (c2, s2, twr, twi, c1, s1)), (L1, L2)


def pfb_reference_np(x: np.ndarray, window: np.ndarray, nchan: int,
                     ntap: int) -> np.ndarray:
    """Plain numpy reference: complex64 [nspec, nchan, ...]."""
    L = 2 * nchan
    nframe = x.shape[0] // L
    nspec = nframe - (ntap - 1)
    tail = x.shape[1:]
    frames = x.reshape((nframe, L) + tail)
    out = np.empty((nspec, nchan) + tail, dtype=np.complex64)
    w = window.reshape((ntap, L) + (1,) * len(tail))
    for s in range(nspec):
        fir = (frames[s:s + ntap] * w).sum(axis=0)
        out[s] = np.fft.rfft(fir, axis=0)[:nchan]
    return out


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest, ties to even, through float32) and
    return in ``t``'s dtype: the operand rounding of a bf16 matrix
    product with float32 accumulation."""
    return t.to(torch.float32).to(torch.bfloat16).to(t.dtype)


def _check_shape(x: torch.Tensor, nchan: int, ntap: int) -> int:
    L = 2 * nchan
    ntime = x.shape[0]
    if x.dim() != 2:
        raise ValueError("adc must be [ntime, ninput]")
    if ntime % L:
        raise ValueError("ntime must be a multiple of 2*nchan")
    nspec = ntime // L - (ntap - 1)
    if nspec <= 0:
        raise ValueError("not enough samples for one spectrum")
    return nspec


def pfb_channelize_planes_imajor(x: torch.Tensor, window, nchan: int,
                                 ntap: int, precision: str = "high"
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Input-major complex-free PFB in float64: (re, im) [ninput, nspec,
    nchan].

    ``precision="high"`` is the exact-arithmetic reference (the JAX
    function's 3-pass bf16 and float32 paths approximate it to ~1e-6).
    ``"bf16"`` rounds every DFT operand to bf16 where the TPU kernel casts
    (``pfb_fused.py:95-102``): the FIR frames and the DFT tables, and in
    the factored transform also the twiddled intermediates; products and
    sums stay exact.  L = 2*nchan takes the direct [L, nchan] tables when
    :func:`_dft_factors` gives None and the factored tables otherwise.
    """
    if precision not in ("high", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    fast = precision == "bf16"
    nspec = _check_shape(x, nchan, ntap)
    L = 2 * nchan
    ninput = x.shape[1]
    dev = x.device
    w = torch.as_tensor(window, dtype=torch.float32).to(dev, torch.float64)
    frames = x.T.to(torch.float64).reshape(ninput, nspec + ntap - 1, L)
    fir = frames[:, 0:nspec] * w[0]
    for k in range(1, ntap):
        fir += frames[:, k:k + nspec] * w[k]
    del frames

    def table(m):
        t = torch.from_numpy(m).to(dev, torch.float64)
        return bf16_round(t) if fast else t

    if fast:
        fir = bf16_round(fir)
    factors = _dft_factors(L)
    if factors is None:
        cos_m, msin_m = rdft_matrices(nchan)
        return fir @ table(cos_m), fir @ table(msin_m)
    tables, (L1, L2) = _rdft_factored_tables(nchan)
    c2, s2, c1, s1 = (table(m) for m in (*tables[:2], *tables[4:]))
    twr, twi = (torch.from_numpy(m).to(dev, torch.float64)
                for m in tables[2:4])
    y = fir.reshape(ninput, nspec, L2, L1).transpose(-1, -2)  # [.., n1, n2]
    del fir
    sr, si = y @ c2, y @ s2                                   # [.., n1, k2]
    tr = sr * twr - si * twi
    ti = sr * twi + si * twr
    del sr, si
    if fast:
        tr, ti = bf16_round(tr), bf16_round(ti)
    tr, ti = tr.transpose(-1, -2), ti.transpose(-1, -2)       # [.., k2, n1]
    xr = tr @ c1 + ti @ s1                                    # [.., k2, k1]
    xi = ti @ c1 - tr @ s1
    # k = k1*L2 + k2
    return (xr.transpose(-1, -2).reshape(ninput, nspec, nchan),
            xi.transpose(-1, -2).reshape(ninput, nspec, nchan))


def _scale_tensor(scale, nchan: int, device) -> torch.Tensor:
    """Scalar or per-channel [nchan] requant gain -> float32 [nchan]."""
    s = torch.as_tensor(scale, dtype=torch.float32).to(device)
    if s.dim() > 1 or (s.dim() == 1 and s.shape[0] != nchan):
        raise ValueError("scale must be a scalar or [nchan]")
    return s.expand(nchan).contiguous()


def quantize_nibbles(v: torch.Tensor) -> torch.Tensor:
    """clip(round(v), -8, 7) with ties to even, as int16."""
    return torch.clamp(torch.round(v), -8, 7).to(torch.int16)


def quantize_pack_imajor(re: torch.Tensor, im: torch.Tensor,
                         scale=1.0) -> torch.Tensor:
    """Quantize+pack input-major planes -> packed uint8
    [ninput, nspec, nchan].  ``scale``: scalar or per-channel [nchan]
    (channel is the last axis)."""
    s = _scale_tensor(scale, re.shape[-1], re.device).to(re.dtype)
    return pack(quantize_nibbles(re * s), quantize_nibbles(im * s))


def quantize_4bit_planes_imajor(re: torch.Tensor, im: torch.Tensor,
                                scale=1.0) -> torch.Tensor:
    """:func:`quantize_pack_imajor`, then the packed bytes transposed to
    the correlator's [nspec, nchan, ninput]."""
    return quantize_pack_imajor(re, im, scale).permute(1, 2, 0)


def _fir_frames(x: torch.Tensor, window, nchan: int, ntap: int
                ) -> torch.Tensor:
    """float64 FIR [nspec, L, ...] of ADC [ntime, ...]: a sum of ntap
    shifted frame views, trailing axes carried through."""
    L = 2 * nchan
    ntime = x.shape[0]
    if ntime % L:
        raise ValueError("ntime must be a multiple of 2*nchan")
    nframe = ntime // L
    nspec = nframe - (ntap - 1)
    if nspec <= 0:
        raise ValueError("not enough samples for one spectrum")
    tail = tuple(x.shape[1:])
    frames = x.reshape((nframe, L) + tail).to(torch.float64)
    w = torch.as_tensor(window, dtype=torch.float32).to(x.device,
                                                        torch.float64)
    wshape = (1, L) + (1,) * len(tail)
    fir = frames[0:nspec] * w[0].reshape(wshape)
    for k in range(1, ntap):
        fir += frames[k:k + nspec] * w[k].reshape(wshape)
    return fir


def pfb_channelize(x: torch.Tensor, window, nchan: int, ntap: int,
                   fft_impl: str = "fft") -> torch.Tensor:
    """Critically sampled real-input PFB: ADC [ntime, ...] with ntime ==
    (nspec + ntap - 1) * 2 * nchan -> complex64 [nspec, nchan, ...], bins
    0..nchan-1 of the real DFT of each FIR frame (the Nyquist bin
    dropped).  FIR and transform in float64 (``torch.fft.rfft``) for both
    ``fft_impl`` names, which the JAX function computes as an FFT or as
    matrix products of the same transform."""
    if fft_impl not in ("fft", "matmul"):
        raise ValueError(f"unknown fft_impl {fft_impl!r}")
    spec = torch.fft.rfft(_fir_frames(x, window, nchan, ntap), dim=1)
    return spec[:, :nchan].to(torch.complex64)


def pfb_channelize_planes(x: torch.Tensor, window, nchan: int, ntap: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`pfb_channelize` as float32 (re, im) planes [nspec, nchan,
    ...]."""
    spec = torch.fft.rfft(_fir_frames(x, window, nchan, ntap),
                          dim=1)[:, :nchan]
    return spec.real.to(torch.float32), spec.imag.to(torch.float32)


def _broadcast_scale(scale, ndim: int, device) -> torch.Tensor:
    """Scalar or per-channel [nchan] requant gain, float32, broadcastable
    over [..., nchan, ninput] spectra."""
    s = torch.as_tensor(scale, dtype=torch.float32).to(device)
    if s.dim() == 1:
        return s.reshape((1,) * (ndim - 2) + (-1, 1))
    return s


def quantize_4bit_planes(re: torch.Tensor, im: torch.Tensor,
                         scale=1.0) -> torch.Tensor:
    """(re, im) float32 planes [..., nchan, ninput] -> packed uint8 of the
    same shape: clip(round(v * scale), -8, 7) with ties to even, in
    float32.  ``scale`` is a scalar or per-channel [nchan]."""
    s = _broadcast_scale(scale, re.dim(), re.device)
    return pack(quantize_nibbles(re.to(torch.float32) * s),
                quantize_nibbles(im.to(torch.float32) * s))


def quantize_4bit(z: torch.Tensor, scale=1.0) -> torch.Tensor:
    """Complex voltages [..., nchan, ninput] -> packed 4+4-bit bytes
    (:func:`quantize_4bit_planes` of the real and imaginary parts)."""
    return quantize_4bit_planes(z.real, z.imag, scale)


#: inputs per chunk of the float64 reference (bounds its FIR to ~0.5 GB
#: at the production width)
_REF_INPUT_CHUNK = 64


def pfb_prequant_ref(x: torch.Tensor, window, nchan: int, ntap: int,
                     scale, fast: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The values the requantizer rounds, v * scale, float64
    [ninput, nspec, nchan] for the real and imaginary parts."""
    re, im = pfb_channelize_planes_imajor(
        x, window, nchan, ntap, precision="bf16" if fast else "high")
    s = _scale_tensor(scale, nchan, x.device).to(torch.float64)
    return re * s, im * s


def _ref_chunks(x: torch.Tensor, window, nchan: int, ntap: int, scale,
                fast: bool):
    """(input slice, pre-quantization planes, packed bytes) of the plain
    version, in chunks of inputs so the float64 FIR stays small."""
    for i0 in range(0, x.shape[1], _REF_INPUT_CHUNK):
        sl = slice(i0, i0 + _REF_INPUT_CHUNK)
        pre = pfb_prequant_ref(x[:, sl], window, nchan, ntap, scale, fast)
        yield sl, pre, pack(quantize_nibbles(pre[0]),
                            quantize_nibbles(pre[1]))


def pfb_quantize_packed_ref(x: torch.Tensor, window, nchan: int, ntap: int,
                            scale, fast: bool = False) -> torch.Tensor:
    """Plain version of the fused channelizer kernel: ADC [ntime, ninput]
    (float32 or int8) -> packed uint8 [ninput, nspec, nchan]."""
    nspec = _check_shape(x, nchan, ntap)
    out = torch.empty((x.shape[1], nspec, nchan), dtype=torch.uint8,
                      device=x.device)
    for sl, _, packed in _ref_chunks(x, window, nchan, ntap, scale, fast):
        out[sl] = packed
    return out


def packed_mismatches(got: torch.Tensor, want: torch.Tensor,
                      pre_re: torch.Tensor, pre_im: torch.Tensor,
                      tol: float = 1e-3) -> tuple[int, int]:
    """Compare packed bytes nibble by nibble.

    A nibble that differs is *tolerated* when the two codes are one step
    apart and the float64 pre-quantization value (v * scale) lies within
    ``tol`` of the rounding threshold between them (a half-integer in
    (-8.5, 7.5)): float32 arithmetic may round it either way.  Returns
    (tolerated, bad) counts of nibbles.
    """
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} vs "
                         f"{tuple(want.shape)}")
    tolerated = bad = 0
    for g, w, pre in zip(unpack(got), unpack(want), (pre_re, pre_im)):
        diff = g != w
        if not bool(diff.any()):
            continue
        g, w = g[diff].to(torch.float64), w[diff].to(torch.float64)
        thresh = torch.minimum(g, w) + 0.5
        ok = ((g - w).abs() == 1) & ((pre[diff] - thresh).abs() <= tol)
        tolerated += int(ok.sum())
        bad += int((~ok).sum())
    return tolerated, bad


def assert_packed_close(got: torch.Tensor, want: torch.Tensor,
                        pre_quant: tuple[torch.Tensor, torch.Tensor],
                        tol: float = 1e-3) -> int:
    """Raise AssertionError unless every differing nibble is tolerated by
    :func:`packed_mismatches`; return the count of tolerated nibbles."""
    tolerated, bad = packed_mismatches(got, want, *pre_quant, tol=tol)
    if bad:
        raise AssertionError(
            f"{bad} packed nibbles differ beyond a rounding threshold "
            f"({tolerated} tolerated at a threshold)")
    return tolerated


def assert_packed_matches_ref(got: torch.Tensor, x: torch.Tensor, window,
                              nchan: int, ntap: int, scale,
                              fast: bool = False) -> int:
    """:func:`assert_packed_close` of ``got`` (e.g. the kernel's bytes for
    ADC ``x``) against the plain version, chunk by chunk; returns the
    count of tolerated threshold cases."""
    tolerated = 0
    for sl, pre, want in _ref_chunks(x, window, nchan, ntap, scale, fast):
        tolerated += assert_packed_close(got[sl], want, pre)
    return tolerated


def channelize_pack_imajor(adc: torch.Tensor, window, cfg,
                           quant_scale) -> torch.Tensor:
    """The production channelizer: ADC [ntime, ninput] -> packed uint8
    [ninput, nspec, nchan] (input-major; callers corner-turn the bytes).

    One path for every ``cfg.pfb_fft_impl`` and ``pfb_engine`` of the JAX
    package: CPU tensors take the float64 plain version, CUDA tensors a
    kernel (factored DFT where L = 2*nchan has a factor pair, else the
    float64 FFT at nchan 192 and 96, else the direct DFT up to nchan =
    559; see :mod:`.pfb_fused`).  ``cfg.pfb_precision == "bf16"`` selects
    the bf16-operand DFT, which the direct kernel computes below
    L = 2048.
    """
    from .pfb_fused import pfb_quantize_packed

    return pfb_quantize_packed(adc, window, cfg.nchan, cfg.pfb_ntap,
                               quant_scale,
                               fast=cfg.pfb_precision == "bf16")


def cdft_matrices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Complex DFT as two f32 matrices [n, n] (cos, -sin)."""
    k = np.arange(n)
    ang = 2 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(np.float32), -np.sin(ang).astype(np.float32)


@contextlib.contextmanager
def full_fp32_matmul():
    """cuBLAS float32 and complex64 products in full float32 while the
    block runs, whatever the caller set: TF32 would round the operands to
    10 mantissa bits (the JAX package asks for ``Precision.HIGH``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def upchannelize(x: torch.Tensor, nup: int, axis_time: int = 0,
                 fft_impl: str = "fft") -> torch.Tensor:
    """Blockwise (zero-overlap) fine channelization.

    Reshapes time into (time, fine_time=nup) frames, FFTs over the fine
    axis and fftshifts so fine channel 0 is the most-negative offset
    (reference: lwa352-upchan-bf.py:94-97 over the 'fine_time' axis).
    The fine axis is made last and contiguous before the transform.

    Args:
      x: complex [ntime, ...] voltages (time on ``axis_time``).
      nup: fine channels per coarse channel.
      fft_impl: "fft" (``torch.fft.fft``) or "matmul" (the two float32
        DFT matrices of :func:`cdft_matrices`, full float32).

    Returns:
      complex64 [ntime//nup, nup, ...]: coarse time x fine channel.
    """
    x = torch.movedim(x, axis_time, 0)
    ntime = x.shape[0]
    if ntime % nup:
        raise ValueError("ntime must be a multiple of nup")
    frames = x.reshape((ntime // nup, nup) + tuple(x.shape[1:]))
    frames = torch.movedim(frames, 1, -1).contiguous()   # [T, ..., nup]
    if fft_impl == "matmul":
        cos_m, msin_m = (torch.from_numpy(m).to(frames.device)
                         for m in cdft_matrices(nup))
        fr = frames.real.float()
        fi = frames.imag.float()
        with full_fp32_matmul():
            re = fr @ cos_m - fi @ msin_m
            im = fr @ msin_m + fi @ cos_m
        fine = torch.complex(re, im)
    elif fft_impl == "fft":
        fine = torch.fft.fft(frames.to(torch.complex64), dim=-1)
    else:
        raise ValueError(f"unknown fft_impl {fft_impl!r}")
    fine = torch.fft.fftshift(fine, dim=-1)
    return torch.movedim(fine, -1, 1).to(torch.complex64)
