"""Gulp correlator over the upper input-tile pairs (kernel for the
``pallas_triu`` engine).

Port of ``caltech_bifrost_dsp_tpu/ops/pallas/corr_triu.py::
packed_corr_triu``: one call correlates a packed block into a fresh pair
of int32 planes, no accumulation.  The CUDA kernel
(``kernels/csrc/corr_triu.cu``) computes only the 128 x 128 input-tile
pairs with tile(j) >= tile(i) and leaves the tiles below the diagonal
zero; consumers mirror at dump time or gather from the upper triangle.
The plain version :func:`corr_triu_ref` is the dense float64 correlation
of :mod:`.correlate`.
"""

from __future__ import annotations

import torch

from .correlate import Vis, chan_major, correlate_chan_major, zero_vis
from .kernels import _build

#: inputs per tile side of the kernel
TILE = 128


def corr_triu_ref(xc: torch.Tensor) -> Vis:
    """Plain version on a chan-major view [nchan, ntime, ninput]: the
    dense matrix (exact)."""
    return correlate_chan_major(xc)


def corr_triu(packed: torch.Tensor, layout: str = "tci",
              ninput: int | None = None) -> Vis:
    """Correlate ``packed`` (uint8, ``layout`` "tci" [ntime, nchan, ninput]
    or "cti" [nchan, ntime, ninput|padded]) into int32 Vis [nchan, ninput,
    ninput]; entries with tile(j) >= tile(i) are valid.

    CPU tensors take :func:`corr_triu_ref`; CUDA tensors launch the kernel
    into zeroed planes.
    """
    xc = chan_major(packed, layout, ninput)
    dev = _build.device_of(xc)
    if dev.type == "cpu":
        return corr_triu_ref(xc)
    nchan, ntime, ni = xc.shape
    if packed.dtype != torch.uint8 or xc.stride(2) != 1:
        raise ValueError("packed must be uint8 with a contiguous input axis")
    out = zero_vis(nchan, ni, dev)
    _build.launch("cbd_corr_triu", dev, xc.data_ptr(), xc.stride(0),
                  xc.stride(1), nchan, ntime, ni, out.real.data_ptr(),
                  out.imag.data_ptr())
    corr_triu.launches += 1
    return out


#: kernel launches made by :func:`corr_triu` in this process
corr_triu.launches = 0
