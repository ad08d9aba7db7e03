"""Fused PFB FIR + real DFT + 4-bit requant (port of
``caltech_bifrost_dsp_tpu/ops/pallas/pfb_fused.py::
pfb_quantize_packed_pallas``).

:func:`pfb_quantize_packed` takes ADC [ntime, ninput] (float32 or int8,
any strides) and returns packed uint8 [ninput, nspec, nchan].  CPU tensors
take the float64 plain version :func:`..pfb.pfb_quantize_packed_ref`;
CUDA tensors launch ``kernels/csrc/pfb_quantize.cu``: :func:`pfb_direct`
below L = 2*nchan = 2048 (the pipeline scale, L = 384) and
:func:`pfb_factored` where :func:`..pfb._dft_factors` gives a factor pair
(the F-engine scale, L = 8192 -> (128, 64)).  Tables are built here once
per (nchan, precision, device) in the layout the kernel reads.

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
#: largest float32 FIR scratch of one factored launch chunk
FACTORED_SCRATCH_BYTES = 1 << 30


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def direct_shared_bytes(L: int, mt: int = 1) -> int:
    """Dynamic shared memory of the direct kernel with ``mt`` spectra a
    block: the folded FIR rows e and o as doubles [kpad][16 mt + 4] and
    the ring of table slabs."""
    kpad = _pad(L // 2 + 1, DIRECT_KS)
    return (2 * kpad * (DIRECT_TI * mt + 4) * 8
            + DIRECT_NSTAGE * 2 * DIRECT_KS * DIRECT_BP * 4)


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


@functools.lru_cache(maxsize=8)
def _factored_tables(nchan: int, fast: bool, device: str):
    """(inner [L2, 2*L2] = (c2, s2) interleaved, twiddle [L1, L2, 2] =
    (twr, twi), outer [L1, L1/2, 2] = (c1, s1)), f32; the inner and outer
    tables bf16-rounded when ``fast`` (the twiddle is an elementwise
    float32 product in the TPU kernel too)."""
    (c2, s2, twr, twi, c1, s1), _ = pfb._rdft_factored_tables(nchan)
    inner = torch.from_numpy(np.stack([c2, s2], -1).reshape(c2.shape[0], -1))
    tw = torch.from_numpy(np.stack([twr, twi], -1))
    outer = torch.from_numpy(np.stack([c1, s1], -1))
    if fast:
        inner, outer = pfb.bf16_round(inner), pfb.bf16_round(outer)
    return tuple(t.contiguous().to(device) for t in (inner, tw, outer))


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
    """Launch the direct-DFT kernel on CUDA tensors (no plain path)."""
    L = 2 * nchan
    if pfb._dft_factors(L) is not None:
        raise ValueError(f"L = {L} takes the factored kernel")
    if direct_shared_bytes(L) > MAX_SHARED:
        raise ValueError(f"L = {L} is too long for the direct kernel's "
                         "shared-memory FIR tile")
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
    """Launch the factored-DFT kernels on CUDA tensors (no plain path)."""
    L = 2 * nchan
    factors = pfb._dft_factors(L)
    if factors is None:
        raise ValueError(f"L = {L} has no factored DFT")
    L1, L2 = factors
    dev, w, sc, nspec, out = _common_args(x, window, scale, nchan, ntap)
    if dev.type != "cuda":
        raise ValueError("pfb_factored launches a CUDA kernel")
    ninput = x.shape[1]
    chunk = max(1, min(nspec, 65535,
                       FACTORED_SCRATCH_BYTES // (ninput * L * 4)))
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


def pfb_quantize_packed(x: torch.Tensor, window, nchan: int, ntap: int,
                        scale, fast: bool = False) -> torch.Tensor:
    """Fused PFB + 4-bit requant: ADC [ntime, ninput] (float32 or int8)
    -> packed uint8 [ninput, nspec, nchan].

    Args:
      window: f32 [ntap, 2*nchan] prototype filter (numpy or tensor).
      scale: scalar or per-channel [nchan] requant gain.
      fast: bf16 DFT operands with float32 accumulation (the JAX
        ``fast=True``, ``pfb_precision="bf16"``) instead of float32.
    """
    if x.device.type == "cpu":
        w = torch.as_tensor(window)
        _check_adc(x, w, nchan, ntap)
        return pfb.pfb_quantize_packed_ref(x, w, nchan, ntap, scale, fast)
    if pfb._dft_factors(2 * nchan) is None:
        return pfb_direct(x, window, nchan, ntap, scale, fast)
    return pfb_factored(x, window, nchan, ntap, scale, fast)


#: kernel launches made by :func:`pfb_direct` / :func:`pfb_factored`
pfb_direct.launches = 0
pfb_factored.launches = 0
