"""Correlator with the fused accumulator algebra (kernel 1).

Port of ``caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py::
packed_corr_blk_acc``.  One call correlates a packed block and applies the
integration-boundary algebra of the reference (corr_block.py:433-445,
corr_acc_block.py:303-306) to the carried state, IN PLACE:

    fast = gulp            if fast_first else fast + gulp
    slow = unchanged       if not fast_last
         = copy of fast    if slow_first
         = slow + fast     otherwise

The CUDA kernel (``kernels/csrc/corr_acc.cu``, int8 tensor-core MMA)
computes only the upper 128 x 128 input-tile pairs, so entries ``j >= i`` of
the state are valid and consumers go through
:func:`..models.xengine.dense_vis` or the subselection gather.  The plain
version :func:`corr_acc_ref` computes the dense matrix.

``unpack_cache=True`` is the port of ``corr_blk.py::_corr_blk_acc_cached``:
a prepass kernel unpacks the block once into sign-extended byte planes and
the contraction reads those; the state comes out bit-identical.
``unpack_cache=None`` (the default) takes the schedule measured faster on
the H100, see :data:`UNPACK_CACHE_DEFAULT`.
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


#: the prepass planes' geometry (``csrc/corr_acc.cu``): inputs padded to
#: whole 128-tiles, time to whole 64-sample chunks of 16 words
_CACHE_TILE, _CACHE_TCHUNK = 128, 64


def cache_shape(nchan: int, ntime: int, ninput: int) -> tuple:
    """Shape of the int32 scratch of the unpack-once kernels: [nchan, 3
    planes (re, im, -re), words of 4 samples, inputs]."""
    nq = -(-ntime // _CACHE_TCHUNK) * (_CACHE_TCHUNK // 4)
    return (nchan, 3, nq, -(-ninput // _CACHE_TILE) * _CACHE_TILE)


def unpack_planes_ref(xc: torch.Tensor) -> torch.Tensor:
    """Plain version of the prepass on a chan-major view [nchan, ntime,
    ninput]: the int32 scratch of :func:`cache_shape`, byte u of word q of
    an input its sample 4 q + u sign-extended (planes re, im, -re), zero
    past ``ntime`` and ``ninput``."""
    nchan, ntime, ninput = xc.shape
    shape = cache_shape(nchan, ntime, ninput)
    x = xc.to(torch.int16)
    re = ((x >> 4) ^ 8) - 8
    im = ((x & 15) ^ 8) - 8
    full = torch.zeros((nchan, 3, 4 * shape[2], shape[3]), dtype=torch.int16)
    for p, plane in enumerate((re, im, -re)):
        full[:, p, :ntime, :ninput] = plane
    b = (full.reshape(nchan, 3, shape[2], 4, shape[3]) & 0xFF).to(torch.int64)
    word = b[:, :, :, 0] | b[:, :, :, 1] << 8 | b[:, :, :, 2] << 16 \
        | b[:, :, :, 3] << 24
    return (((word + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


#: what ``unpack_cache=None`` resolves to (the JAX function resolves it
#: from its TPU measurement, ops/pallas/corr_blk.py:173-184; this is the
#: H100's): at 704 inputs x 192 channels x 2400 spectra the unpack-once
#: pair takes 3.94 ms a call and the kernel that unpacks its own tiles
#: 10.75 ms (NVIDIA H100 80GB HBM3, 700.00 W; ``chip_smoke.py``, CUDA events
#: over 5 calls of each in one process)
UNPACK_CACHE_DEFAULT = True


def corr_acc(packed: torch.Tensor, fast: Vis, slow: Vis, fast_first: bool,
             fast_last: bool, slow_first: bool, layout: str = "tci",
             unpack_cache: bool | None = None) -> None:
    """Correlate ``packed`` (uint8, ``layout`` "tci" [ntime, nchan, ninput]
    or "cti" [nchan, ntime, ninput|padded]) into the state planes in place.

    CPU tensors take :func:`corr_acc_ref`; CUDA tensors launch the kernel:
    with ``unpack_cache`` the unpack-once pair (prepass + contraction from
    the cached planes, a per-call scratch in device memory), else the
    kernel that unpacks its tiles itself; ``None`` takes
    :data:`UNPACK_CACHE_DEFAULT`.  Same state either way.
    """
    if unpack_cache is None:
        unpack_cache = UNPACK_CACHE_DEFAULT
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
