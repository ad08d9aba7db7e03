"""Fused PFB FIR + real DFT + 4-bit requant (port of
``caltech_bifrost_dsp_tpu/ops/pallas/pfb_fused.py::
pfb_quantize_packed_pallas``).

:func:`pfb_quantize_packed` takes ADC [ntime, ninput] (float32 or int8,
any strides) and returns packed uint8 [ninput, nspec, nchan].  CPU tensors
take the float64 plain version :func:`..pfb.pfb_quantize_packed_ref`;
CUDA tensors launch the kernel :func:`kernel_for` names:
:func:`pfb_factored` (``kernels/csrc/pfb_quantize.cu``) where
:func:`..pfb._dft_factors` gives a factor pair the kernel tiles (the
F-engine scale, L = 2*nchan = 8192 -> (128, 64)); else, in the float32
mode, :func:`pfb_fft` (``kernels/csrc/pfb_fft.cu``, a factored real FFT in
float64) at the lengths it is compiled for (:data:`FFT_NCHAN`: the
pipeline scale, L = 384, and L = 192) where its shared memory holds the
window (:func:`fft_shared_bytes`); else :func:`pfb_direct`
(``pfb_quantize.cu``, the folded DFT on the FP64 tensor cores, and the
only kernel of the bf16 mode below L = 2048) while the folded FIR rows of
one 16-input tile fit shared memory (``direct_shared_bytes(L) <=
MAX_SHARED``: nchan <= :func:`direct_max_nchan` = 559).  A length no
kernel takes (nchan 560-1023, or L >= 2048 without a usable factor pair)
raises ``ValueError`` for a CUDA tensor; the CPU path answers every
length.  Tables are built here once per (nchan, precision, device) in the
layout the kernel reads.

The TPU kernel's ``ti``/``ts`` tiles, ``paired``, ``fir_impl`` and
``pipeline_chunks`` are Mosaic scheduling choices with identical output
and have no counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import pfb
from .kernels import _build

#: direct mode (``csrc/pfb_quantize.cu``): inputs of one block, spectra of
#: one block (3, or 1 where 3 do not fit), table rows per slab, channels per
#: pass, slab row pitch in floats, slabs in the copy ring
DIRECT_TI, DIRECT_MT, DIRECT_KS, DIRECT_CPASS, DIRECT_BP = 16, 3, 8, 192, 200
DIRECT_NSTAGE = 4
#: shared memory one block may use (H100: 227 KB)
MAX_SHARED = 232448
#: largest float32 FIR scratch of one launch pair of the factored mode
#: (FIR-rows kernel, then the DFT kernel that reads the rows back)
FACTORED_SCRATCH_BYTES = 1 << 30
#: pad floats per staged row of the factored DFT kernel
FACTORED_PAD = 8
#: the FFT kernel (``csrc/pfb_fft.cu``): the channel counts it is compiled
#: for (L = 8 M, M samples a lane) and the warps of a block
FFT_NCHAN = (96, 192)
FFT_WARPS = 8


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def direct_shared_bytes(L: int, mt: int = 1) -> int:
    """Dynamic shared memory of the direct kernel with ``mt`` spectra a
    block: the folded FIR rows e and o as doubles [kpad][16 mt + 4] and
    the ring of table slabs."""
    kpad = _pad(L // 2 + 1, DIRECT_KS)
    return (2 * kpad * (DIRECT_TI * mt + 4) * 8
            + DIRECT_NSTAGE * 2 * DIRECT_KS * DIRECT_BP * 4)


def direct_max_nchan() -> int:
    """The largest nchan whose folded FIR rows (one spectrum of one
    16-input tile) fit the direct kernel's shared memory."""
    nchan = 1
    while direct_shared_bytes(2 * (nchan + 1)) <= MAX_SHARED:
        nchan += 1
    return nchan


def factored_shared_bytes(L1: int, L2: int) -> int:
    """Dynamic shared memory of the factored DFT kernel: one FIR row as
    [L2][L1 + 8] floats and the twiddled intermediate's two planes
    [L1][L2 + 8]."""
    return (L2 * (L1 + FACTORED_PAD) + 2 * L1 * (L2 + FACTORED_PAD)) * 4


def fft_shared_bytes(nchan: int, ntap: int, ring: bool = True) -> int:
    """Dynamic shared memory of the FFT kernel (``pfb_fft.cu::fft_smem``):
    per warp the FIR rows [4][L + 8] as doubles, which the lanes'
    transforms [32][M/2 + 1] complex overwrite, and four packed rows of
    nchan + 16 bytes; the window [ntap][L] and its offsets [L] as doubles,
    the twiddles [8][M/2 + 1] complex and the halved scale [nchan]; for
    int8 ADC (``ring``) ntap + 3 frames of 8 words x (L + 4)."""
    L = 2 * nchan
    M = L // 8
    warp = max(4 * (L + 8) * 8, 32 * (M // 2 + 1) * 16) + 4 * (nchan + 16)
    return (FFT_WARPS * warp + (ntap + 1) * L * 8 + 8 * (M // 2 + 1) * 16
            + nchan * 8 + ((ntap + 3) * 8 * (L + 4) * 4 if ring else 0))


def fft_takes(nchan: int, ntap: int, dtype: torch.dtype) -> bool:
    """True where :func:`pfb_fft` takes the length: nchan in
    :data:`FFT_NCHAN` and its shared memory (the ring of int8 frames
    grows with ntap) within ``MAX_SHARED``."""
    return (nchan in FFT_NCHAN and fft_shared_bytes(
        nchan, ntap, dtype == torch.int8) <= MAX_SHARED)


def fft_twiddles_ref(nchan: int) -> np.ndarray:
    """The FFT kernel's stage-2 twiddles, float64 [8, nchan / 8 + 1, 2]:
    entry [j, a] = (cos, -sin)(2 pi j a / L), W_L^(j a) for lane j of a row
    and the lanes' bin a <= M / 2 (L = 2 nchan = 8 M)."""
    L = 2 * nchan
    ang = 2 * np.pi * np.outer(np.arange(8), np.arange(L // 16 + 1)) / L
    return np.ascontiguousarray(np.stack([np.cos(ang), -np.sin(ang)], -1))


@functools.lru_cache(maxsize=8)
def _fft_twiddles(nchan: int, device: str) -> torch.Tensor:
    """:func:`fft_twiddles_ref` on ``device``."""
    return torch.from_numpy(fft_twiddles_ref(nchan)).to(device)


def direct_table_ref(nchan: int) -> np.ndarray:
    """The folded real-DFT table [npass, kpad / 8, 2, 8, 192] f32: entry
    [p, k // 8, 0, k % 8, c % 192] is cos(2 pi k c / L) for k <= nchan and
    [.., 1, ..] is -sin(2 pi k c / L) for 0 < k < nchan, from rows
    k <= nchan of :func:`..pfb.rdft_matrices`; zero elsewhere.  With
    e[k] = x[k] + x[L - k], o[k] = x[k] - x[L - k] (e[0] = x[0],
    e[nchan] = x[nchan]): Re X = e . cos, Im X = o . (-sin)."""
    cos_m, msin_m = pfb.rdft_matrices(nchan)
    kpad = _pad(nchan + 1, DIRECT_KS)
    npad = _pad(nchan, DIRECT_CPASS)
    t = np.zeros((2, kpad, npad), np.float32)
    t[0, :nchan + 1, :nchan] = cos_m[:nchan + 1]
    t[1, 1:nchan, :nchan] = msin_m[1:nchan]
    t = t.reshape(2, kpad // DIRECT_KS, DIRECT_KS, npad // DIRECT_CPASS,
                  DIRECT_CPASS)
    return np.ascontiguousarray(t.transpose(3, 1, 0, 2, 4))


def fold_ref(fir: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel's fold of FIR rows [..., L] into float64
    (e, o) [..., nchan + 1]."""
    L = fir.shape[-1]
    nchan = L // 2
    x = fir.to(torch.float64)
    e = x[..., :nchan + 1].clone()
    o = torch.zeros_like(e)
    mirror = x[..., nchan + 1:].flip(-1)
    e[..., 1:nchan] += mirror
    o[..., 1:nchan] = x[..., 1:nchan] - mirror
    return e, o


@functools.lru_cache(maxsize=16)
def _direct_table(nchan: int, fast: bool, device: str) -> torch.Tensor:
    """:func:`direct_table_ref` on ``device``, bf16-rounded when ``fast``."""
    t = torch.from_numpy(direct_table_ref(nchan))
    return (pfb.bf16_round(t) if fast else t).to(device)


def factored_tables_ref(nchan: int, half: bool = True
                        ) -> tuple[np.ndarray, ...]:
    """The factored kernel's tables (f32) from
    :func:`..pfb._rdft_factored_tables`:

    - inner [L2 (n2), L2]: the half of the inner DFT a real input needs,
      (cos, sin) of one k2 in neighbouring columns: column 2u = c2[:, u] and
      column 2u + 1 = s2[:, u] for 0 < u < L2/2; columns 0 and 1 are the two
      real bins, c2[:, 0] and c2[:, L2/2].  ``half=False`` (the kernel's
      bf16 mode, which does not mirror): [L2, 2 L2], every k2;
    - twiddle [L1, L2, 2] = (twr, twi);
    - outer [2, L1 (n1), L1/2 (k1)] = (c1, s1).
    """
    (c2, s2, twr, twi, c1, s1), (_, L2) = pfb._rdft_factored_tables(nchan)
    if half:
        inner = np.stack([c2[:, :L2 // 2], s2[:, :L2 // 2]], -1)
        inner[:, 0, 1] = c2[:, L2 // 2]
    else:
        inner = np.stack([c2, s2], -1)
    return (np.ascontiguousarray(inner.reshape(L2, -1)),
            np.ascontiguousarray(np.stack([twr, twi], -1)),
            np.ascontiguousarray(np.stack([c1, s1])))


@functools.lru_cache(maxsize=8)
def _factored_tables(nchan: int, fast: bool, device: str):
    """:func:`factored_tables_ref` on ``device``; the inner and outer
    tables bf16-rounded when ``fast`` (the twiddle is an elementwise
    float32 product in the TPU kernel too)."""
    inner, tw, outer = (torch.from_numpy(t)
                        for t in factored_tables_ref(nchan, half=not fast))
    if fast:
        inner, outer = pfb.bf16_round(inner), pfb.bf16_round(outer)
    return tuple(t.to(device) for t in (inner, tw, outer))


def factored_chunk(ninput: int, nspec: int, L: int) -> int:
    """Spectra per launch pair of the factored mode: as many as keep the
    float32 FIR scratch [ninput, chunk, L] within
    ``FACTORED_SCRATCH_BYTES`` (and the grid within 65535)."""
    return max(1, min(nspec, 65535,
                      FACTORED_SCRATCH_BYTES // (ninput * L * 4)))


def _check_adc(x: torch.Tensor, window: torch.Tensor, nchan: int,
               ntap: int) -> int:
    if x.dtype not in (torch.float32, torch.int8):
        raise ValueError(f"adc dtype must be float32 or int8, got {x.dtype}")
    nspec = pfb._check_shape(x, nchan, ntap)
    if tuple(window.shape) != (ntap, 2 * nchan):
        raise ValueError(f"window must be [{ntap}, {2 * nchan}]")
    return nspec


def _common_args(x, window, scale, nchan, ntap):
    dev = x.device
    w = torch.as_tensor(window).to(dev, torch.float32).contiguous()
    nspec = _check_adc(x, w, nchan, ntap)
    sc = pfb._scale_tensor(scale, nchan, dev)
    out = torch.empty((x.shape[1], nspec, nchan), dtype=torch.uint8,
                      device=dev)
    return dev, w, sc, nspec, out


def pfb_direct(x: torch.Tensor, window, nchan: int, ntap: int, scale,
               fast: bool = False) -> torch.Tensor:
    """Launch the direct-DFT kernel on CUDA tensors (no plain path).
    Takes nchan <= :func:`direct_max_nchan` (559): the folded FIR rows of
    a block live in shared memory; raises ``ValueError`` above."""
    L = 2 * nchan
    if pfb._dft_factors(L) is not None:
        raise ValueError(f"L = {L} takes the factored kernel")
    if direct_shared_bytes(L) > MAX_SHARED:
        raise ValueError(
            f"L = {L} is too long for the direct kernel's shared-memory "
            f"FIR tile ({direct_shared_bytes(L)} > {MAX_SHARED} bytes; "
            f"nchan <= {direct_max_nchan()})")
    dev, w, sc, nspec, out = _common_args(x, window, scale, nchan, ntap)
    if dev.type != "cuda":
        raise ValueError("pfb_direct launches a CUDA kernel")
    table = _direct_table(nchan, fast, str(dev))
    _build.launch("cbd_pfb_direct", dev, x.data_ptr(), x.stride(0),
                  x.stride(1), int(x.dtype == torch.int8), x.shape[1], nspec,
                  nchan, ntap, w.data_ptr(), table.data_ptr(),
                  table.shape[1] * DIRECT_KS, table.shape[0] * DIRECT_CPASS,
                  sc.data_ptr(), int(fast), out.data_ptr())
    pfb_direct.launches += 1
    return out


def pfb_factored(x: torch.Tensor, window, nchan: int, ntap: int, scale,
                 fast: bool = False) -> torch.Tensor:
    """Launch the factored-DFT kernels on CUDA tensors (no plain path).
    Takes the factor pairs (L1, L2) of :func:`..pfb._dft_factors` with
    L1 % 16 == 0 and L2 % 8 == 0 whose row fits shared memory
    (:func:`factored_shared_bytes`); raises ``ValueError`` otherwise."""
    L = 2 * nchan
    factors = pfb._dft_factors(L)
    if factors is None:
        raise ValueError(f"L = {L} has no factored DFT")
    L1, L2 = factors
    if L1 % 16 or L2 % 8 or factored_shared_bytes(L1, L2) > MAX_SHARED:
        raise ValueError(
            f"L = {L} = {L1} x {L2}: the factored kernel takes L1 % 16 == 0 "
            f"and L2 % 8 == 0 within {MAX_SHARED} bytes of shared memory")
    dev, w, sc, nspec, out = _common_args(x, window, scale, nchan, ntap)
    if dev.type != "cuda":
        raise ValueError("pfb_factored launches a CUDA kernel")
    ninput = x.shape[1]
    chunk = factored_chunk(ninput, nspec, L)
    scratch = torch.empty((ninput, chunk, L), dtype=torch.float32,
                          device=out.device)
    inner, tw, outer = _factored_tables(nchan, fast, str(dev))
    _build.launch("cbd_pfb_factored", dev, x.data_ptr(), x.stride(0),
                  x.stride(1), int(x.dtype == torch.int8), ninput, nspec,
                  nchan, ntap, L1, L2, w.data_ptr(), inner.data_ptr(),
                  tw.data_ptr(), outer.data_ptr(), sc.data_ptr(), int(fast),
                  scratch.data_ptr(), chunk, out.data_ptr())
    pfb_factored.launches += 1
    return out


def pfb_fft(x: torch.Tensor, window, nchan: int, ntap: int, scale,
            fast: bool = False) -> torch.Tensor:
    """Launch the factored real-FFT kernel on CUDA tensors (no plain
    path): the float32 mode at nchan in :data:`FFT_NCHAN` where
    :func:`fft_takes`; raises ``ValueError`` otherwise, and for ``fast``
    (the bf16 mode is a DFT matrix product of bf16 operands, which
    :func:`pfb_direct` computes)."""
    if fast:
        raise ValueError("pfb_fft computes the float32 mode only")
    if not fft_takes(nchan, ntap, x.dtype):
        raise ValueError(
            f"the FFT kernel takes nchan in {FFT_NCHAN} within {MAX_SHARED} "
            f"bytes of shared memory, not nchan = {nchan} at ntap = {ntap}")
    dev, w, sc, nspec, out = _common_args(x, window, scale, nchan, ntap)
    if dev.type != "cuda":
        raise ValueError("pfb_fft launches a CUDA kernel")
    tw = _fft_twiddles(nchan, str(dev))
    _build.launch("cbd_pfb_fft", dev, x.data_ptr(), x.stride(0), x.stride(1),
                  int(x.dtype == torch.int8), x.shape[1], nspec, nchan, ntap,
                  w.data_ptr(), tw.data_ptr(), sc.data_ptr(), out.data_ptr())
    pfb_fft.launches += 1
    return out


def kernel_for(x: torch.Tensor, nchan: int, ntap: int, fast: bool):
    """The launcher :func:`pfb_quantize_packed` takes for CUDA ADC ``x``:
    :func:`pfb_factored` where L = 2 nchan has a factor pair, else
    :func:`pfb_fft` in the float32 mode where it takes the length, else
    :func:`pfb_direct`."""
    if pfb._dft_factors(2 * nchan) is not None:
        return pfb_factored
    if not fast and fft_takes(nchan, ntap, x.dtype):
        return pfb_fft
    return pfb_direct


def pfb_quantize_packed(x: torch.Tensor, window, nchan: int, ntap: int,
                        scale, fast: bool = False) -> torch.Tensor:
    """Fused PFB + 4-bit requant: ADC [ntime, ninput] (float32 or int8)
    -> packed uint8 [ninput, nspec, nchan].

    Args:
      window: f32 [ntap, 2*nchan] prototype filter (numpy or tensor).
      scale: scalar or per-channel [nchan] requant gain.
      fast: bf16 DFT operands with float32 accumulation (the JAX
        ``fast=True``, ``pfb_precision="bf16"``) instead of float32.

    A CUDA tensor launches :func:`kernel_for`'s kernel and raises
    ``ValueError`` for a length none takes (nchan 560-1023:
    ``direct_shared_bytes(L) > MAX_SHARED``; L >= 2048 without a factor
    pair with L1 % 16 == 0 and L2 % 8 == 0).  A CPU tensor takes the plain
    version at every length.
    """
    if x.device.type == "cpu":
        w = torch.as_tensor(window)
        _check_adc(x, w, nchan, ntap)
        return pfb.pfb_quantize_packed_ref(x, w, nchan, ntap, scale, fast)
    return kernel_for(x, nchan, ntap, fast)(x, window, nchan, ntap, scale,
                                           fast)


#: kernel launches made by :func:`pfb_direct` / :func:`pfb_factored` /
#: :func:`pfb_fft`
pfb_direct.launches = 0
pfb_factored.launches = 0
pfb_fft.launches = 0
