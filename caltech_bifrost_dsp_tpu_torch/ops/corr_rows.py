"""Row-streamed gulp correlator.

Port of ``caltech_bifrost_dsp_tpu/ops/pallas/corr_rows.py::
packed_corr_rows``: the function of :mod:`.corr_triu` on a (channel, row
tile) grid.  The CUDA kernel (``kernels/csrc/corr_rows.cu``) keeps a row
tile's unpacked operand resident in shared memory and walks the ``j >= i``
column tiles, writing row strips; the output contract is that of
:func:`.corr_triu.corr_triu` (128-input tiles, tile(j) >= tile(i) valid,
tiles below the diagonal zero).  As in the JAX package no engine name
selects it: it is reached from its tests and the smoke run.  The plain
version :func:`corr_rows_ref` is the dense float64 correlation of
:mod:`.correlate`.
"""

from __future__ import annotations

import torch

from .correlate import Vis, chan_major, correlate_chan_major, zero_vis
from .kernels import _build

#: inputs per tile side of the kernel
TILE = 128


def corr_rows_ref(xc: torch.Tensor) -> Vis:
    """Plain version on a chan-major view [nchan, ntime, ninput]: the
    dense matrix (exact)."""
    return correlate_chan_major(xc)


def corr_rows(packed: torch.Tensor, layout: str = "tci",
              ninput: int | None = None) -> Vis:
    """Correlate ``packed`` (uint8, ``layout`` "tci" [ntime, nchan, ninput]
    or "cti" [nchan, ntime, ninput|padded]) into int32 Vis [nchan, ninput,
    ninput]; entries with tile(j) >= tile(i) are valid.

    CPU tensors take :func:`corr_rows_ref`; CUDA tensors launch the kernel
    into zeroed planes.
    """
    xc = chan_major(packed, layout, ninput)
    dev = _build.device_of(xc)
    if dev.type == "cpu":
        return corr_rows_ref(xc)
    nchan, ntime, ni = xc.shape
    if packed.dtype != torch.uint8 or xc.stride(2) != 1:
        raise ValueError("packed must be uint8 with a contiguous input axis")
    out = zero_vis(nchan, ni, dev)
    _build.launch("cbd_corr_rows", dev, xc.data_ptr(), xc.stride(0),
                  xc.stride(1), nchan, ntime, ni, out.real.data_ptr(),
                  out.imag.data_ptr())
    corr_rows.launches += 1
    return out


#: kernel launches made by :func:`corr_rows` in this process
corr_rows.launches = 0
