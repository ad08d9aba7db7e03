"""Full-array cross-correlation, plain PyTorch reference.

Port of ``caltech_bifrost_dsp_tpu/ops/correlate.py``:

    V[c, i, j] = sum_t  x[t, c, i] * conj(x[t, c, j])

Inputs are ordered ``input = npol*stand + pol``, so ``V`` follows the
golden-vector convention ``corr[..., s0, s1, p0, p1] = v(s0, p0) *
conj(v(s1, p1))``.  The plain path multiplies in float64 batched matmuls:
every product and partial sum is an integer far below 2^53, so the result
is exact and no TF32 mode can touch it.  The hot path is the CUDA kernel
in :mod:`.corr_acc`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.codec import unpack


class Vis(NamedTuple):
    """Integer visibilities as int32 planes [nchan, ninput, ninput]."""
    real: torch.Tensor
    imag: torch.Tensor

    @property
    def nchan(self) -> int:
        return self.real.shape[0]

    @property
    def ninput(self) -> int:
        return self.real.shape[1]

    def __add__(self, other: "Vis") -> "Vis":
        return Vis(self.real + other.real, self.imag + other.imag)


def zero_vis(nchan: int, ninput: int, device=None) -> Vis:
    """Two separately allocated zero planes: the correlator kernel updates
    accumulators in place, so the planes must never alias."""
    def z():
        return torch.zeros((nchan, ninput, ninput), dtype=torch.int32,
                           device=device)
    return Vis(z(), z())


def chan_major(packed: torch.Tensor, layout: str,
               ninput: int | None = None) -> torch.Tensor:
    """[nchan, ntime, ninput] view of a packed gulp, without a copy.

    ``layout="tci"`` is the capture-ring order [ntime, nchan, ninput];
    ``layout="cti"`` is [nchan, ntime, ninput|padded], whose pad lanes
    past ``ninput`` are don't-care bytes and are sliced away here.
    """
    if layout == "tci":
        xc = packed.permute(1, 0, 2)
    elif layout == "cti":
        xc = packed
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if ninput is not None:
        if xc.shape[2] < ninput:
            raise ValueError(f"packed input axis {xc.shape[2]} narrower "
                             f"than ninput {ninput}")
        xc = xc[:, :, :ninput]
    return xc


def correlate_chan_major(xc: torch.Tensor) -> Vis:
    """Correlate a chan-major packed view [nchan, ntime, ninput] (exact)."""
    xr, xi = unpack(xc)
    xr = xr.to(torch.float64)
    xi = xi.to(torch.float64)
    a = torch.cat([xr, xi], dim=1)                  # [c, 2t, n]
    vr = torch.bmm(a.transpose(1, 2), a)            # xr^T xr + xi^T xi
    ir = torch.bmm(xi.transpose(1, 2), xr)          # sum_t xi_i xr_j
    vi = ir - ir.transpose(1, 2)                    # xi_i xr_j - xr_i xi_j
    return Vis(vr.to(torch.int32), vi.to(torch.int32))


def correlate_gulp(packed: torch.Tensor) -> Vis:
    """Correlate one gulp of packed samples uint8 [ntime, nchan, ninput]
    into int32 Vis [nchan, ninput, ninput]."""
    return correlate_chan_major(chan_major(packed, "tci"))


def correlate_accumulate(packed: torch.Tensor, ntime_gulp: int,
                         acc: Vis | None = None) -> Vis:
    """Correlate-and-accumulate ``k * ntime_gulp`` spectra onto ``acc``.

    The sum over gulps equals one correlation over the whole block (the
    float64 contraction is exact), so the block is contracted at once.
    """
    ntime, nchan, ninput = packed.shape
    if ntime % ntime_gulp != 0:
        raise ValueError(f"ntime {ntime} not a multiple of gulp {ntime_gulp}")
    vis = correlate_gulp(packed)
    return vis if acc is None else acc + vis


def vis_to_numpy_complex(vis: Vis) -> np.ndarray:
    """Dense complex128 numpy view for verification (exact: int32 fits
    float64)."""
    return (vis.real.cpu().numpy().astype(np.int64)
            + 1j * vis.imag.cpu().numpy().astype(np.int64)
            ).astype(np.complex128)


def long_accumulate(vis_new: Vis, vis_acc: Vis) -> Vis:
    """One CorrAcc step: int32 add of a fast dump into the slow accumulator
    (the reference's ``BFMap("a += b")``, corr_acc_block.py:304-306)."""
    return vis_acc + vis_new


def autocorr_spectra(vis_dense, nstand: int, npol: int = 2) -> np.ndarray:
    """Per-stand autocorrelation spectra from a dense visibility cube
    [nchan, ninput, ninput] (complex, or the real plane alone) -> real f32
    [nstand, npol, nchan].  The one home of the input order
    (input = stand * npol + pol); numpy, as the sink that calls it."""
    v = np.asarray(vis_dense)
    nin = nstand * npol
    diag = np.real(v[:, np.arange(nin), np.arange(nin)])
    return diag.T.reshape(nstand, npol, v.shape[0]).astype(np.float32)


def mirror_vis(vis: Vis) -> Vis:
    """Hermitian fill: the valid ``j >= i`` half -> full dense matrix
    (port of ``ops/pallas/corr_triu.py::mirror_vis``)."""
    ni = vis.real.shape[1]
    idx = torch.arange(ni, device=vis.real.device)
    upper = (idx[None, :] >= idx[:, None])[None]
    vr = torch.where(upper, vis.real, vis.real.transpose(1, 2))
    vi = torch.where(upper, vis.imag, -vis.imag.transpose(1, 2))
    return Vis(vr, vi)
