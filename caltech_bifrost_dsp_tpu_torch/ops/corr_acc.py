"""Correlator with the fused accumulator algebra (kernel 1).

Port of ``caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py::
packed_corr_blk_acc``.  One call correlates a packed block and applies the
integration-boundary algebra of the reference (corr_block.py:433-445,
corr_acc_block.py:303-306) to the carried state, IN PLACE:

    fast = gulp            if fast_first else fast + gulp
    slow = unchanged       if not fast_last
         = copy of fast    if slow_first
         = slow + fast     otherwise

The CUDA kernel (``kernels/csrc/corr_acc.cu``) computes only the upper
64 x 64 input-tile pairs, so entries ``j >= i`` of the state are valid and
consumers go through :func:`..models.xengine.dense_vis` or the subselection
gather.  The plain version :func:`corr_acc_ref` computes the dense matrix.

``unpack_cache=True`` is the port of ``corr_blk.py::_corr_blk_acc_cached``:
a prepass kernel unpacks the block once into sign-extended byte planes and
the contraction reads those; the state comes out bit-identical.
"""

from __future__ import annotations

import torch

from .correlate import Vis, chan_major, correlate_chan_major
from .kernels import _build


def corr_acc_ref(xc: torch.Tensor, fast: Vis, slow: Vis, fast_first: bool,
                 fast_last: bool, slow_first: bool) -> None:
    """Plain version on a chan-major view [nchan, ntime, ninput]; updates
    ``fast`` and ``slow`` in place."""
    gulp = correlate_chan_major(xc)
    for acc, new in zip(fast, gulp):
        if fast_first:
            acc.copy_(new)
        else:
            acc.add_(new)
    if fast_last:
        for acc, f in zip(slow, fast):
            if slow_first:
                acc.copy_(f)
            else:
                acc.add_(f)


#: the cached variant's plane geometry (``csrc/corr_acc.cu``): inputs
#: padded to whole 64-tiles, time to whole 32-sample chunks of 8 words
_CACHE_TILE, _CACHE_TCHUNK = 64, 32


def cache_shape(nchan: int, ntime: int, ninput: int) -> tuple:
    """Shape of the int32 scratch of ``unpack_cache=True``: [nchan, 4
    planes (re, im, im - re, re + im), words of 4 samples, inputs]."""
    nq = -(-ntime // _CACHE_TCHUNK) * (_CACHE_TCHUNK // 4)
    return (nchan, 4, nq, -(-ninput // _CACHE_TILE) * _CACHE_TILE)


def corr_acc(packed: torch.Tensor, fast: Vis, slow: Vis, fast_first: bool,
             fast_last: bool, slow_first: bool, layout: str = "tci",
             unpack_cache: bool = False) -> None:
    """Correlate ``packed`` (uint8, ``layout`` "tci" [ntime, nchan, ninput]
    or "cti" [nchan, ntime, ninput|padded]) into the state planes in place.

    CPU tensors take :func:`corr_acc_ref`; CUDA tensors launch the kernel:
    with ``unpack_cache`` the unpack-once pair (prepass + contraction from
    the cached planes, a per-call scratch in device memory), else the
    kernel that unpacks its tiles itself.  Same state either way.
    """
    ninput = fast.ninput
    xc = chan_major(packed, layout, ninput)
    planes = (*fast, *slow)
    dev = _build.device_of(xc, *planes)
    if dev.type == "cpu":
        corr_acc_ref(xc, fast, slow, fast_first, fast_last, slow_first)
        return
    nchan, ntime, _ = xc.shape
    if packed.dtype != torch.uint8 or xc.stride(2) != 1:
        raise ValueError("packed must be uint8 with a contiguous input axis")
    _build.require_contiguous(*planes)
    for p in planes:
        if p.dtype != torch.int32 or p.shape != (nchan, ninput, ninput):
            raise ValueError("state planes must be int32 "
                             f"[{nchan}, {ninput}, {ninput}]")
    if len({p.data_ptr() for p in planes}) != len(planes):
        raise ValueError("state planes must not alias")
    flags = (int(fast_first), int(fast_last), int(slow_first))
    if unpack_cache:
        scratch = torch.empty(cache_shape(nchan, ntime, ninput),
                              dtype=torch.int32, device=dev)
        _build.launch("cbd_corr_acc_cached", dev, xc.data_ptr(),
                      xc.stride(0), xc.stride(1), nchan, ntime, ninput,
                      scratch.data_ptr(), scratch.numel(),
                      *(p.data_ptr() for p in planes), *flags)
        corr_acc.cached_launches += 1
        return
    _build.launch("cbd_corr_acc", dev, xc.data_ptr(), xc.stride(0),
                  xc.stride(1), nchan, ntime, ninput,
                  *(p.data_ptr() for p in planes), *flags)
    corr_acc.launches += 1


#: kernel launches made by :func:`corr_acc` in this process: the default
#: kernel, and the unpack-once pair (one count per call)
corr_acc.launches = 0
corr_acc.cached_launches = 0
