"""The card's yardstick: published peaks of one NVIDIA H100 and the least
time a function's work can take on it, read the same way whatever computes
the function (a kernel of the port's, its plain version, a library call).

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the memory rate, and its
operations over the peak rate of their type: :func:`bound` of a
``*_work`` function's (bytes, operations, type).  The peaks are the H100 SXM
data sheet's dense rates at a 700 W power limit; a card set below it runs
slower under load, so every time is printed beside :func:`card`.

:func:`cuda_ms` times a call on the card with CUDA events.
"""

from __future__ import annotations

import math
import os
import subprocess
from pathlib import Path

import torch

#: H100 SXM HBM3 rate, bytes/s
HBM_BYTES_S = 3.35e12
#: H100 SXM dense peaks, operations/s: int8 and bf16 on the tensor cores,
#: FP64 on the tensor cores, float32 outside them
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "fp64": 67e12, "fp32": 67e12}


def bound(nbyte: float, nop: float, kind: str,
          hbm_bytes_s: float = HBM_BYTES_S, peaks: dict | None = None
          ) -> dict:
    """The least time the card could take for ``nbyte`` bytes moved and
    ``nop`` operations of type ``kind`` (a key of :data:`PEAK_OPS_S`, or
    of ``peaks`` where given): ``{"bound_ms", "bound_by": "bytes" or
    "operations"}``."""
    t_bytes = nbyte / hbm_bytes_s * 1e3
    t_ops = nop / (peaks or PEAK_OPS_S)[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def corr_work(nchan: int, ntime: int, ni: int, tile: int,
              nplane_read: int, nplane_written: int) -> tuple:
    """(bytes, operations, type) of a correlator call: the packed block
    in, ``nplane_*`` int32 planes' valid tiles (tile(j) >= tile(i)) in and
    out; 4 real multiply-adds per time sample, channel and input pair
    i <= j on the int8 tensor cores."""
    nt = -(-ni // tile)
    valid = sum(min(tile, ni - a * tile) * min(tile, ni - b * tile)
                for a in range(nt) for b in range(a, nt))
    nbyte = nchan * ntime * ni + (nplane_read + nplane_written) * 4 * \
        nchan * valid
    return nbyte, 8 * nchan * ntime * ni * (ni + 1) / 2, "int8"


def pfb_work(adc_nbyte: int, ninput: int, nspec: int, nchan: int,
             ntap: int) -> tuple:
    """(bytes, operations, type) of the channelizer: ``adc_nbyte`` bytes
    of ADC in, packed bytes out; the FIR's 2 * ntap operations per sample
    and a real FFT's 2.5 log2(L) (the least count for the transform,
    whatever the kernel does) in float32."""
    L = 2 * nchan
    nbyte = adc_nbyte + ninput * nspec * nchan
    return (nbyte, nspec * ninput * L * (2 * ntap + 2.5 * math.log2(L)),
            "fp32")


def beamform_work(nchan: int, ntime: int, ninput: int, nbeam: int,
                  ntime_sum: int, vlbi: bool = True,
                  kind: str = "bf16") -> tuple:
    """(bytes, operations, ``kind``) of the beamformer: packed block and
    float32 gains in, powers [nbeam/2, ntime/ntime_sum, nchan, 4] (and
    VLBI [ntime, nchan, 2, 2]) out; 8 operations per channel, sample,
    beam and input."""
    nbyte = (nchan * ntime * ninput + 8 * nchan * nbeam * ninput
             + 4 * (nbeam // 2) * (ntime // ntime_sum) * nchan * 4
             + (4 * ntime * nchan * 4 if vlbi else 0))
    return nbyte, 8 * nchan * ntime * nbeam * ninput, kind


def subsel_work(nvis: int, nchan: int, nchan_sum: int) -> tuple:
    """(bytes, operations, type) of the baseline gather: two int32 planes
    read at ``nvis`` pairs over every channel, the pairs read, two planes
    of nchan / nchan_sum channel sums written."""
    nco = nchan // nchan_sum
    return 8 * nvis * (nchan + nco + 1), 2 * nvis * nchan, "fp32"


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up
    call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    """``name, power.limit`` of the first GPU, as nvidia-smi prints it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()


def card_fields() -> dict:
    """The card a measurement ran beside, for its JSON line:
    ``{"device": name, "power_limit": limit}``, both None on a host
    without nvidia-smi (a host-only run)."""
    try:
        name, limit = (x.strip() for x in card().split(",", 1))
    except (OSError, subprocess.CalledProcessError, IndexError, ValueError):
        return {"device": None, "power_limit": None}
    return {"device": name, "power_limit": limit}


def current_commit() -> str | None:
    """The code a record was made from: ``CBD_COMMIT``, else ``git
    rev-parse HEAD`` where the checkout is a repository (a copy made with
    ``git archive`` has no ``.git``: name its commit in ``CBD_COMMIT``)."""
    if os.environ.get("CBD_COMMIT"):
        return os.environ["CBD_COMMIT"]
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            check=True, cwd=Path(__file__).resolve().parents[2]
        ).stdout.strip() or None
    except (OSError, subprocess.CalledProcessError):
        return None
