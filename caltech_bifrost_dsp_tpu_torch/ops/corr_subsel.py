"""Baseline subselection with channel averaging (kernel 3).

Port of ``caltech_bifrost_dsp_tpu/ops/corr_subsel.py``: pick ``nvis_out``
single-pol visibilities by (stand, pol) pairs and sum groups of
``nchan_sum`` adjacent channels.  The gather reads the upper triangle only
(``v[i0, i1] == conj(v[i1, i0])``), so it works on the correlator's
upper-valid accumulators without a mirror.  The CUDA kernel
(``kernels/csrc/subsel_gather.cu``) replaces the TPU slab extractors
``block_extract``/``band_extract`` and the take around them, and the
lane-gather kernel ``corr_subsel_pallas``: every engine name of
:func:`corr_subsel_engine` computes the one gather.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .correlate import Vis
from .kernels import _build


def baselines_to_inputs(baselines, npol: int = 2) -> np.ndarray:
    """[nvis, 2, 2] listing of ((s0, p0), (s1, p1)) -> [nvis, 2] input
    indices; the first entry is the unconjugated input."""
    b = np.asarray(baselines, dtype=np.int64)
    if b.ndim != 3 or b.shape[1:] != (2, 2):
        raise ValueError("baselines must be [nvis, 2, 2]")
    return b[:, :, 0] * npol + b[:, :, 1]


def default_baselines(nvis_out: int, nstand: int) -> list:
    """Default selection: pol-0 autos cycling over stands
    (reference: corr_subsel_block.py:231-233)."""
    return [[[i % nstand, 0], [i % nstand, 0]] for i in range(nvis_out)]


def production_baselines(nvis_out: int, nstand: int,
                         npol: int = 2) -> list:
    """Every pol pair of every stand pair (autos included) among the first
    K stands, where ``K*(K+1)/2 * npol**2 == nvis_out`` (4704 = 48 stands,
    reference: corr_subsel_block.py:185); :func:`default_baselines` when
    nvis_out is not such a count."""
    k = int((math.isqrt(8 * (nvis_out // npol ** 2) + 1) - 1) // 2)
    if k * (k + 1) // 2 * npol ** 2 != nvis_out or k > nstand:
        return default_baselines(nvis_out, nstand)
    return [[[s0, p0], [s1, p1]]
            for s0 in range(k) for s1 in range(s0, k)
            for p0 in range(npol) for p1 in range(npol)]


def corr_subsel_ref(vis: Vis, input_pairs: torch.Tensor, nchan_sum: int
                    ) -> Vis:
    """Plain version of :func:`corr_subsel`."""
    nchan, ninput, _ = vis.real.shape
    pairs = input_pairs.to(torch.int64).clamp(0, ninput - 1)
    i0, i1 = pairs[:, 0], pairs[:, 1]
    lo = torch.minimum(i0, i1)
    hi = torch.maximum(i0, i1)
    sign = torch.where(i0 <= i1, 1, -1).to(torch.int32)
    idx = lo * ninput + hi
    sel_r = vis.real.reshape(nchan, ninput * ninput)[:, idx]
    sel_i = vis.imag.reshape(nchan, ninput * ninput)[:, idx] * sign

    def csum(x):
        return x.reshape(nchan // nchan_sum, nchan_sum, -1).sum(
            dim=1, dtype=torch.int32)

    return Vis(csum(sel_r), csum(sel_i))


def corr_subsel(vis: Vis, input_pairs: torch.Tensor, nchan_sum: int) -> Vis:
    """Gather + channel sum (kernel 3).

    Args:
      vis: int32 planes [nchan, ninput, ninput], entries j >= i valid.
      input_pairs: int32 [nvis, 2] (unconjugated, conjugated) inputs; a
        malformed index clamps to [0, ninput - 1] before lo/hi and the
        conjugation sign are taken (xengine.py:94-99).
      nchan_sum: adjacent channels summed per output channel.

    Returns:
      int32 Vis [nchan // nchan_sum, nvis].
    CPU tensors take :func:`corr_subsel_ref`; CUDA tensors launch the
    kernel.
    """
    nchan, ninput, _ = vis.real.shape
    if nchan % nchan_sum:
        raise ValueError("nchan must be a multiple of nchan_sum")
    dev = _build.device_of(*vis, input_pairs)
    if dev.type == "cpu":
        return corr_subsel_ref(vis, input_pairs, nchan_sum)
    nvis = input_pairs.shape[0]
    if input_pairs.dtype != torch.int32 or input_pairs.shape != (nvis, 2):
        raise ValueError("input_pairs must be int32 [nvis, 2]")
    if (vis.imag.shape != vis.real.shape
            or any(p.dtype != torch.int32 for p in vis)):
        raise ValueError("vis planes must be int32 of one shape")
    _build.require_contiguous(*vis, input_pairs)
    out = Vis(torch.empty((nchan // nchan_sum, nvis), dtype=torch.int32,
                          device=dev),
              torch.empty((nchan // nchan_sum, nvis), dtype=torch.int32,
                          device=dev))
    _build.launch("cbd_subsel_gather", dev, vis.real.data_ptr(),
                  vis.imag.data_ptr(), nchan, ninput,
                  input_pairs.data_ptr(), nvis, nchan_sum,
                  out.real.data_ptr(), out.imag.data_ptr())
    corr_subsel.launches += 1
    return out


#: kernel launches made by :func:`corr_subsel` in this process
corr_subsel.launches = 0

#: ``cfg.subsel_engine`` names (``ops/corr_subsel.py::corr_subsel_engine``)
SUBSEL_ENGINES = ("xla", "bands", "pallas")


def corr_subsel_engine(vis: Vis, input_pairs: torch.Tensor, nchan_sum: int,
                       engine: str) -> Vis:
    """Engine dispatch of the JAX step.  The JAX engines (flat take,
    band-compacted slabs, the Pallas lane gather) differ only in how a
    TPU reads the cube and give bit-identical output; here each name runs
    :func:`corr_subsel`, the gather kernel on CUDA tensors and the plain
    version on CPU tensors."""
    if engine not in SUBSEL_ENGINES:
        raise ValueError(f"unknown subsel engine {engine!r}")
    return corr_subsel(vis, input_pairs, nchan_sum)


def subsel_output_sfreq(sfreq: float, bw_hz: float, nchan: int,
                        nchan_sum: int) -> float:
    """Output header sfreq arithmetic, kept reference-identical
    (reference: corr_subsel_block.py:268-270)."""
    chan_width = bw_hz / nchan
    return (sfreq + ((nchan_sum - 1) * chan_width)) / nchan_sum
