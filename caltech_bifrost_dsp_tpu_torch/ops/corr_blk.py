"""Gulp correlator over the upper 128-input tile pairs (the sharded
programs' ``pallas_blk`` engine).

Port of ``caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py::packed_corr_blk``:
one call correlates a packed block into a fresh pair of int32 planes and
reads no state.  The CUDA kernel (``cbd_corr_blk`` in
``kernels/csrc/corr_acc.cu``) is the tensor-core tile contraction of the
fused correlator without its epilogue, fed from the same unpack-once planes
(a per-call scratch in device memory): it writes only the tile pairs with
tile(j) >= tile(i), so entries ``j >= i`` are valid and the tiles below the
diagonal stay zero; consumers mirror at dump time or gather from the upper
triangle.  It masks ragged edges itself, so the TPU kernel's 256-padded
accumulator variant (``slice_out=False``) has no counterpart.  The packed
operand may be a strided view of a larger block in chan and time (a shard
of a gulp that lives on one card).  The plain version :func:`corr_blk_ref`
is the dense float64 correlation of :mod:`.correlate`.
"""

from __future__ import annotations

import torch

from .corr_acc import cache_shape
from .correlate import Vis, chan_major, correlate_chan_major, zero_vis
from .kernels import _build

#: inputs per tile side of the kernel
TILE = 128


def corr_blk_ref(xc: torch.Tensor) -> Vis:
    """Plain version on a chan-major view [nchan, ntime, ninput]: the
    dense matrix (exact)."""
    return correlate_chan_major(xc)


def corr_blk(packed: torch.Tensor, layout: str = "tci",
             ninput: int | None = None) -> Vis:
    """Correlate ``packed`` (uint8, ``layout`` "tci" [ntime, nchan, ninput]
    or "cti" [nchan, ntime, ninput|padded]) into int32 Vis [nchan, ninput,
    ninput]; entries with tile(j) >= tile(i) are valid.

    CPU tensors take :func:`corr_blk_ref`; CUDA tensors launch the kernel
    into zeroed planes.
    """
    xc = chan_major(packed, layout, ninput)
    dev = _build.device_of(xc)
    if dev.type == "cpu":
        return corr_blk_ref(xc)
    nchan, ntime, ni = xc.shape
    if packed.dtype != torch.uint8 or xc.stride(2) != 1:
        raise ValueError("packed must be uint8 with a contiguous input axis")
    out = zero_vis(nchan, ni, dev)
    scratch = torch.empty(cache_shape(nchan, ntime, ni), dtype=torch.int32,
                          device=dev)
    _build.launch("cbd_corr_blk", dev, xc.data_ptr(), xc.stride(0),
                  xc.stride(1), nchan, ntime, ni, scratch.data_ptr(),
                  scratch.numel(), out.real.data_ptr(), out.imag.data_ptr())
    corr_blk.launches += 1
    return out


#: kernel launches made by :func:`corr_blk` in this process
corr_blk.launches = 0
