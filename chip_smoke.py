"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from ``caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc``,
holds each against its plain PyTorch version at the LWA-352 production
shapes (704 inputs, 192 channels, 2400-spectra window, 32 beams; the
channelizer also at the 4096-channel F-engine width; the correlators
also at a ragged shape, and the two that unpack their own tiles,
``corr_triu`` and ``corr_rows``, also on structured and all-0x88 blocks,
after the compiler's report of their registers and spills; the gather
also timed alone, as a CUDA graph of bare launches, beside its wrapper),
then drives eleven paths of the port, each with the kernel launch counts
set to 0 just before it and read just after:

- X/B: the served :class:`XEnginePipeline` over the golden input stream
  (seed 0xdeadbeef), three fast windows at 192 channels, every product
  kept by a ``ProductKeeper`` sink and each fast dump's matrix read where
  the compute thread queues it, then the port's
  golden-parity gate (``scripts/gpu_parity.py``, the JAX package's
  ``scripts/tpu_parity.py`` at its full depth) in process: ``xengine_step``
  with ``TPU_ENGINES`` in the padded chan-major staging over three golden
  windows at 192 channels and three at 184, every fast, slow, subselection
  and VLBI element exact against the host's truth, and its FX leg, the
  direct channelizer against a float64 host PFB;
- FX: :class:`XEnginePipeline` in FX mode on int8 ADC, three windows and
  a slow dump at 192 channels, one at 184, one with float32 ADC (bytes equal
  to the int8 run's) and one tone window; per window the channelizer's
  bytes are gated against the float64 plain version, the X/B products are
  held exactly against the plain versions on those bytes, and the code
  histogram must not be degenerate;
- F-engine: ``channelize_pack_imajor`` at 4096 channels x 704 inputs x 240
  spectra (the factored DFT), gated the same way;
- driver: the operator entry point's :class:`XEnginePipeline` (ingest,
  compute and output threads) over three golden windows and one slow
  dump, twice: with the ``pallas_triu``/``pallas``/``pallas`` engines and
  with ``config.TPU_ENGINES``.  Integer gains arrive through the
  ``Beamform`` command key and the baseline selection through
  ``CorrSubsel``; the COR slow-dump packets, collected through ``send``,
  scatter back exactly to the plain slow dump, and the subselection, PBEAM
  and IBEAM packets, received on loopback UDP sockets by threads of this
  script, decode to the plain products (subselection and VLBI exact,
  power within rtol 1e-4);
- mesh: the sharded programs of ``parallel/mesh.py`` with the
  ``pallas_blk`` engines on 2x2 and 1x4 meshes whose four shards all lie
  on ``cuda:0``: the X/B configuration's three golden windows gulp by gulp
  and the slow dump through ``xengine_sharded_state_fn``, one int8 FX
  window with a carried ADC tail through ``fx_sharded_state_fn`` at 2x2,
  integers (and the packed bytes after the corner-turn) equal to the
  unsharded step's and beam products within rtol 1e-4; then
  ``XEnginePipeline(mesh=2x2)`` over the driver path's windows with every
  sink, its packets byte for byte those of the unsharded driver run;
- wire: the driver's C++ COR sink (``CorrFullOutput(native_dest=...)``,
  the packetizer of ``io/native.py``) on the plain slow dump alone, to a
  receiver in a process of its own (the rate cap the first at which every
  packet arrives), its packets byte for byte the Python encoder's in the
  driver run; then the driver fed by ``native.CaptureSource`` from a snap2
  blaster in another process (the same golden windows over loopback, paced
  by ``delay_ns``, 0 packets missing; its COR slow dump through the C++
  packetizer at that cap), each fast dump equal to the plain correlator's
  and every sink's packets byte for byte those of the golden-source run;
  last, one int8 FX window of two gulps over ``AdcCaptureSource``, its
  packets those of the same samples fed in process.  The COR receiver
  hands its packets back through shared memory.

A run then drives the two correlator schedules that no engine name
selects, ``corr_acc`` with the ``unpack_cache`` that is not the default and
``corr_rows``, over the golden stream through their wrappers and holds
their slow sums to the plain slow dump.

The seventh path, control and record, follows: the driver over the
golden windows without and with a 10-frame history ring (649 MB) on a
``kv://`` store served in process, a trigger through the port's
``PipelineControl`` while the ring fills and one after the run; every file
byte for byte the golden gulps at its ``seq0``, the two windows of the
second replayed through the driver (fast dump, subselection and VLBI
exact against the plain products) and written again with O_DIRECT
(bytes equal); one int8 FX window with a 5-frame ADC ring, its dump equal
to the ADC fed in and its replay giving the live run's packed bytes and
fast dump exactly; then ``xeng_manager --serve-kv`` as a subprocess
starting the port's CLI on golden vectors at full width with ``--etcdhost
kv://``, ``--bufgbytes 0.7`` and ``--dump-direct``, armed by
``CorrelatorControl.arm_and_wait``, its dump checked, stopped with exit
code 0 and every slow dump equal to the golden file; last, one command
over the etcd3 wire where ``grpc`` is installed (a line says so where it
is not).  It prints the ms of a ring push, the driver's rate with and
without the ring, the longest push gap during a dump, the dump MB/s
buffered and direct (and whether the filesystem took O_DIRECT) and the
``kv://`` round trips.

The eighth path, offline replay and reception, ends the run: one golden
window (2400 spectra x 192 channels x 704 inputs, 324 MB) through a
``HistoryRing`` and ``TriggeredDump`` into a file, replayed by the
port's ``upchan_bf`` (nup 32, 4 beams, accumulated powers and
``--voltages``; gulp 0 and the last gulp, whose weights were recomputed
at sample 1440, within rtol 1e-4, atol 1e-4 x max of float64 truths) and
``upchan_imag`` (nup 2 over 384 fine channels: one integration equal to a
float64 truth on 18 channels and Hermitian on all, then 720 frames and a
480-frame tail summing exactly to it), through ``main`` where ``h5py``
imports and otherwise through the same replay without the writers (a
line says so); the three offline functions timed a gulp beside their
bounds; then one driver run whose subselection, PBEAM and COR streams
(paced at ``RX_COR_MBPS``) go to ``corr_part_rx``, ``beam_rx --capture``
and ``corr_rx --cor-fmt``, each ``python -m`` in a process of its own,
their files equal to the driver path's truths with no packet lost.

The ninth path, one mesh across processes, follows: two processes of
this script (``--multihost-worker``) join a gloo group and form one 2x2
mesh over ``cuda:0`` with ``parallel/multihost.py``, two shards each,
first with the chan columns and then with the time rows spread over the
processes; each runs the first golden window gulp by gulp through
``xengine_sharded_state_fn`` (fast partials carried, the fast dump, the
first slow update) and one int8 FX window through
``fx_sharded_state_fn``, gathers every product with
``process_allgather``, and reports its SHA-256, its launch counts, its
wall per window, the bytes and seconds of each collective that crossed
processes and the device ms of a dump call; every product must equal the
single-process 2x2 mesh's on the same inputs byte for byte, in both
processes.

The tenth path, the measuring entry points, runs the port's five bench
scripts through their ``main()`` at full width with short runs:
``bench_step`` (5 windows; the end's ``xengine_step`` figure is its),
``bench_pipeline`` on the card (with the ramp source and with
``--skip-write``), with the stub device at that step time and
``--skip-write``, and with the stub device fed by native capture at the
wire path's pace, ``bench_stages`` (every stage), ``bench_ingest`` (20
gulps, plain and with the upload) and ``bench_scaling`` (1x1, 1x2, 2x2
on this card).  Each JSON line is printed and checked: its keys, finite
and positive numbers, no stage over 1.05 of its bound, no kernel launched
by a stub run, the X/B kernels launched by the step and the correlator by
the driver on the card.

The eleventh path, the soak, follows: ``scripts/soak.py``'s full leg at
the full LWA-352 width, cut to ``SOAK_SECONDS`` at ``SOAK_RATE`` gulps a
second with slow dumps of ``SOAK_ACC_LEN_SLOW`` spectra:
``native.CaptureSource`` fed by a blaster process cycling five seeded
gulps, every sink live over loopback UDP to a receiver process per
stream, the 1000-gulp sequence break half way, a dump triggered through
the control client and replayed, the monitor bridge; every fast window's
subselection (decoded from its packets) and every slow dump exact against
the plain correlator's truth on both sides of the break, RSS and
``memory_reserved`` within their gates; then ``examples/demo_torch.py``
on the card, every slow dump equal to its golden file.  The soak's
launches are counted from the end of its warm-up pipeline to the end of
its paced run, and each X/B kernel must be among them; the demo's are
counted around the demo.

Beside the four tensor-core kernels it times a library contraction as a
yardstick, on earlier lines and labelled "contraction only":
``torch._int_mm`` on unpacked int8 planes beside the correlator, float32 and
float64 ``torch.matmul`` of the DFT's shape beside the direct channelizer,
a complex64 ``torch.bmm`` on unpacked voltages beside the beamformer and
``torch.fft.rfft`` over float32 rows beside the factored channelizer.
They leave out the unpack, the FIR, the epilogue and the requantizer, so
``library_ms`` stays null; the port never calls them.

It times each kernel beside its plain version and its bound (the larger
of bytes moved over the memory rate and operations over the peak rate),
the X/B step (both correlator engines) and the FX step per window,
unsharded and sharded, and the driver's host time per window (with the C++
and the Python COR encoders) and captured rate.  The last line is
``{"ok": true, "device": ...}``; any
failure raises and exits non-zero.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import faulthandler
import filecmp
import hashlib
import importlib.util
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from multiprocessing import shared_memory
from pathlib import Path

import numpy as np
import torch

from caltech_bifrost_dsp_tpu_torch.config import LWA352, TPU_ENGINES
from caltech_bifrost_dsp_tpu_torch.control.client import (CorrControlClient,
                                                          CorrelatorControl,
                                                          PipelineControl)
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.control.etcd3_wire import Etcd3Server
from caltech_bifrost_dsp_tpu_torch.control.netstore import StoreServer
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore, connect
from caltech_bifrost_dsp_tpu_torch.io import native
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch.io.source import (ADCSource,
                                                     SyntheticSource,
                                                     TriggerFileSource,
                                                     sequence_header)
from caltech_bifrost_dsp_tpu_torch.models import offline
from caltech_bifrost_dsp_tpu_torch.models.xengine import (dense_vis, fx_step,
                                                          init_state,
                                                          xengine_step)
from caltech_bifrost_dsp_tpu_torch.ops import beamform as bf
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs
from caltech_bifrost_dsp_tpu_torch.ops import pfb, pfb_fused
from caltech_bifrost_dsp_tpu_torch.ops.corr_acc import (UNPACK_CACHE_DEFAULT,
                                                        corr_acc,
                                                        corr_acc_ref)
from caltech_bifrost_dsp_tpu_torch.ops import corr_blk as cblk
from caltech_bifrost_dsp_tpu_torch.ops import corr_rows as crows
from caltech_bifrost_dsp_tpu_torch.ops.corr_triu import (TILE, corr_triu,
                                                         corr_triu_ref)
from caltech_bifrost_dsp_tpu_torch.ops.correlate import (Vis, chan_major,
                                                         correlate_chan_major)
from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build
from caltech_bifrost_dsp_tpu_torch.parallel import mesh as pm
from caltech_bifrost_dsp_tpu_torch.parallel import multihost
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.runtime.ring import HistoryRing
from caltech_bifrost_dsp_tpu_torch.scripts import (bench_ingest,
                                                   bench_pipeline,
                                                   bench_scaling,
                                                   bench_stages, bench_step,
                                                   gpu_parity, probe_subsel,
                                                   soak,
                                                   soak_wire,
                                                   upchan_bf, upchan_imag)
from caltech_bifrost_dsp_tpu_torch.utils.codec import unpack_complex_np
from caltech_bifrost_dsp_tpu_torch.utils.roofline import (
    HBM_BYTES_S, PEAK_OPS_S, beamform_work, bound, card as card_name,
    corr_work, cuda_ms, pfb_work, subsel_work)
from caltech_bifrost_dsp_tpu_torch.verification import golden

SEED = 0xdeadbeef
PFB_TOLERANCE = ("packed bytes vs the float64 plain version: a nibble may "
                 "differ by one code only where the float64 value lies "
                 "within 1e-3 of the rounding threshold, and such cases "
                 "are <= 1e-6 of the codes (max_abs_err is in codes)")
KERNELS = {
    "corr_acc": dict(
        fn=corr_acc, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_acc.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py:123",
        tolerance="exact int32 on j >= i"),
    "corr_acc_cached": dict(
        fn=corr_acc, counter="cached_launches", route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_acc.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py:267",
        tolerance="exact int32 on j >= i; every plane bit-identical to "
                  "corr_acc's"),
    "corr_blk": dict(
        fn=cblk.corr_blk, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_acc.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py:402",
        tolerance="exact int32 on the 128-input tiles with tile(j) >= "
                  "tile(i); tiles below the diagonal stay zero"),
    "corr_rows": dict(
        fn=crows.corr_rows, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_rows.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_rows.py:82",
        tolerance="exact int32 on the 128-input tiles with tile(j) >= "
                  "tile(i); tiles below the diagonal stay zero"),
    "corr_triu": dict(
        fn=corr_triu, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_triu.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_triu.py:69",
        tolerance="exact int32 on the 128-input tiles with tile(j) >= "
                  "tile(i); tiles below the diagonal stay zero"),
    "beamform_products": dict(
        fn=bf.beamform_products, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/"
               "beamform_products.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/beamform_fused.py:161",
        tolerance="rtol 1e-4, atol 1e-4 * max|plain|; VLBI exact with "
                  "integer gains"),
    "subsel_gather": dict(
        fn=cs.corr_subsel, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/"
               "subsel_gather.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/subsel_gather.py:162",
        also_replaces=[
            "caltech_bifrost_dsp_tpu/ops/pallas/subsel_gather.py:221",
            "caltech_bifrost_dsp_tpu/ops/pallas/subsel_gather.py:82"],
        tolerance="exact int32"),
    "pfb_direct": dict(
        fn=pfb_fused.pfb_direct, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/"
               "pfb_quantize.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/pfb_fused.py:434",
        tolerance=PFB_TOLERANCE),
    "pfb_factored": dict(
        fn=pfb_fused.pfb_factored, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/"
               "pfb_quantize.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/pfb_fused.py:383",
        tolerance=PFB_TOLERANCE),
    "pfb_fft": dict(
        fn=pfb_fused.pfb_fft, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/pfb_fft.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/pfb_fused.py:434",
        tolerance=PFB_TOLERANCE),
}
#: the fused correlator's entry that ``corr_acc(unpack_cache=None)``, and so
#: the main path, launches; the other schedule runs in the schedules run
DEFAULT_CORR = "corr_acc_cached" if UNPACK_CACHE_DEFAULT else "corr_acc"
#: why no kernel has a library time: no single PyTorch call computes its
#: function on its inputs (4+4-bit packed bytes in, or a fused chain out)
NO_LIBRARY = None
#: the FX operating point: int8 ADC, one slow dump after three windows
FX_CFG = LWA352.replace(adc_dtype="int8", acc_len_slow=7200)


def channelizer(cfg) -> str:
    """The entry of ``KERNELS`` that an FX window at ``cfg`` launches
    (``ops/pfb_fused.py::kernel_for``)."""
    x = torch.empty(0, dtype=torch.int8 if cfg.adc_dtype == "int8"
                    else torch.float32)
    return pfb_fused.kernel_for(x, cfg.nchan, cfg.pfb_ntap,
                                cfg.pfb_precision == "bf16").__name__


FENGINE_NCHAN, FENGINE_NSPEC = 4096, 240
TONE_CHAN = 77
# the production selection plus one malformed pair (stand 400 of 352)
PAIRS = np.concatenate([
    cs.baselines_to_inputs(cs.production_baselines(LWA352.nvis_out,
                                                   LWA352.nstand)),
    cs.baselines_to_inputs([[[400, 0], [3, 1]]])]).astype(np.int32)
#: the driver path: three windows and one slow dump at full width
DRIVER_CFG = LWA352.replace(acc_len_slow=7200)
DRIVER_ENGINES = {
    "pallas_triu": dict(corr_engine="pallas_triu", subsel_engine="pallas",
                        bf_engine="pallas"),
    "TPU_ENGINES": dict(TPU_ENGINES),
}
#: the driver's selection: production, the last entry malformed (stand 400)
DRIVER_BASELINES = (cs.production_baselines(LWA352.nvis_out, LWA352.nstand)
                    [:-1] + [[[400, 0], [3, 1]]])
SYNC_TIME = 1_700_000_000


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def power_close(got, want) -> bool:
    """The reference's beam gate: rtol 1e-4, atol 1e-4 * max|truth|."""
    return bool(torch.allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max())))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_kernels(dev, card: str, results: dict) -> None:
    """Each kernel against its plain version at the production shapes."""
    cfg = LWA352
    nchan, ni, ntime = cfg.nchan, cfg.ninput, cfg.acc_len
    g = torch.Generator(device=dev).manual_seed(SEED)
    packed = torch.randint(0, 256, (ntime, nchan, ni), generator=g,
                           device=dev, dtype=torch.uint8)
    xc = chan_major(packed, "tci")
    upper = torch.triu(torch.ones((ni, ni), dtype=torch.bool, device=dev))

    def rand_planes():
        return [torch.randint(-2 ** 20, 2 ** 20, (nchan, ni, ni),
                              generator=g, device=dev, dtype=torch.int32)
                for _ in range(4)]

    err = 0.0
    for flags in [(True, False, False), (False, False, False),
                  (False, True, True), (False, True, False),
                  (True, True, False), (True, True, True)]:
        init = rand_planes()
        want = [p.clone() for p in init]
        corr_acc_ref(xc, Vis(*want[:2]), Vis(*want[2:]), *flags)
        got = init
        corr_acc(packed, Vis(*got[:2]), Vis(*got[2:]), *flags,
                 unpack_cache=False)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            check(torch.equal(a[:, upper], b[:, upper]),
                  f"corr_acc != plain on j >= i, flags {flags}")
            err = max(err, max_abs(a[:, upper], b[:, upper]))
        print(f"corr_acc flags {flags}: exact int32 on j >= i", flush=True)
    del want
    state = rand_planes()
    fast, slow = Vis(*state[:2]), Vis(*state[2:])
    ms = cuda_ms(lambda: corr_acc(packed, fast, slow, False, True, False,
                                  unpack_cache=False), 5)
    plain_ms = cuda_ms(lambda: corr_acc_ref(xc, fast, slow, False, True,
                                            False), 2)
    # flags (False, True, False): all four planes read and written
    results["corr_acc"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               **bound(*corr_work(nchan, ntime, ni, 64, 4,
                                                  4)))
    phase_cached(dev, card, results, packed, xc, upper, rand_planes,
                 plain_ms)
    int_mm_yardstick(card, packed)

    pairs = torch.from_numpy(PAIRS).to(dev)
    got = cs.corr_subsel(fast, pairs, cfg.nchan_sum)
    want = cs.corr_subsel_ref(fast, pairs, cfg.nchan_sum)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        check(torch.equal(a, b), "subsel != plain")
    print("subsel_gather: exact int32, malformed pair included", flush=True)
    phase_subsel(card, results, fast, pairs, got, want)
    del fast, slow, state

    err = 0.0
    rel = {}
    for kind in ("integer", "float"):
        shape = (nchan, cfg.nbeam, ni)
        if kind == "integer":
            gains = bf.BeamGains(*(torch.randint(-8, 9, shape, generator=g,
                                                 device=dev).float()
                                   for _ in range(2)))
        else:
            gains = bf.BeamGains(*(torch.randn(shape, generator=g,
                                               device=dev)
                                   for _ in range(2)))
        p, v = bf.beamform_products(packed, gains, cfg.ntime_sum)
        wp, wv = bf.beamform_products_ref(xc, gains, cfg.ntime_sum)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(p).all() and torch.isfinite(v).all()),
              "beam products not finite")
        check(power_close(p, wp), f"beam power ({kind} gains) vs plain")
        if kind == "integer":
            check(torch.equal(v, wv), "VLBI (integer gains) not exact")
        else:
            check(power_close(v, wv), "VLBI (float gains) vs plain")
        err = max(err, max_abs(p, wp), max_abs(v, wv))
        rel[kind] = (max_abs(p, wp) / float(wp.abs().max()),
                     max_abs(v, wv) / float(wv.abs().max()))
        print(f"beamform_products {kind} gains: power max|err|/max "
              f"{rel[kind][0]:.3e}, VLBI max|err| {max_abs(v, wv):.3e}",
              flush=True)
    # gains changed in place take effect at the next call: doubled gains,
    # four times the power (exact: a factor of two moves no rounding)
    for plane in gains:
        plane.mul_(2.0)
    p2, v2 = bf.beamform_products(packed, gains, cfg.ntime_sum)
    torch.cuda.synchronize()
    check(torch.equal(p2, 4.0 * p) and torch.equal(v2, 2.0 * v),
          "beam products did not follow gains changed in place")
    for plane in gains:
        plane.mul_(0.5)
    del p2, v2
    print("beamform_products: gains doubled in place -> power x 4, VLBI x 2 "
          "exactly (no stale split operand)", flush=True)
    beam_cancellation(dev, g)
    nbyte = (packed.numel() + 8 * gains.real.numel() + 4 * p.numel()
             + 4 * v.numel())
    nop = 8 * nchan * ntime * cfg.nbeam * ni
    results["beamform_products"].update(
        **bound(*beamform_work(nchan, ntime, ni, cfg.nbeam,
                               cfg.ntime_sum)),
        max_abs_err=err,
        ms=cuda_ms(lambda: bf.beamform_products(packed, gains,
                                                cfg.ntime_sum), 10),
        plain_ms=cuda_ms(lambda: bf.beamform_products_ref(
            xc, gains, cfg.ntime_sum), 3))
    r = results["beamform_products"]
    print(f"[{card}] beamform_products on the bf16 tensor cores, "
          f"{bf.SPLIT_TERMS} bf16 terms per float32 gain: kernel "
          f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms; largest error "
          f"against float64 over max|truth|: power {rel['float'][0]:.3e}, "
          f"VLBI {rel['float'][1]:.3e}; bound by bytes "
          f"{nbyte / HBM_BYTES_S * 1e3:.3f} ms, by operations at the bf16 "
          f"tensor rate {nop / PEAK_OPS_S['bf16'] * 1e3:.3f} ms (at the "
          f"float32 rate, the bound of the FMA kernel this one replaced: "
          f"{nop / PEAK_OPS_S['fp32'] * 1e3:.3f} ms)", flush=True)
    bmm_yardstick(card, packed, gains)
    for name in ("corr_acc", "corr_acc_cached", "beamform_products",
                 "subsel_gather"):
        print_kernel(card, name, results[name], "per call at the production "
                     "shape")


def phase_subsel(card: str, results: dict, vis: Vis, pairs, got,
                 want) -> None:
    """The gather's device time alone (a CUDA graph of bare launches on
    preallocated outputs, ``scripts/probe_subsel.py``) and through its
    wrapper, beside its byte bound; the compiler's report of each
    instantiation."""
    cfg = LWA352
    nchan_sum = cfg.nchan_sum
    nvis = pairs.shape[0]
    ptxas_report(card, {"subsel_gather_kernel": 5})
    out = Vis(torch.empty_like(got.real), torch.empty_like(got.imag))
    launch = probe_subsel.bare_launch(_build.library().cbd_subsel_gather,
                                      vis, pairs, nchan_sum, out)
    device_ms = probe_subsel.graph_ms(launch)
    check(torch.equal(out.real, want.real) and torch.equal(out.imag,
                                                          want.imag),
          "subsel: bare launches != plain")
    wrapper_ms, host_ms = probe_subsel.wrapper_ms(vis, pairs, nchan_sum)
    r = results["subsel_gather"]
    r.update(**bound(*subsel_work(nvis, cfg.nchan, nchan_sum)),
             max_abs_err=max(max_abs(a, b) for a, b in zip(got, want)),
             ms=device_ms, wrapper_ms=wrapper_ms, wrapper_host_ms=host_ms,
             plain_ms=cuda_ms(lambda: cs.corr_subsel_ref(vis, pairs,
                                                         nchan_sum), 5))
    print(f"[{card}] subsel_gather at {nvis} pairs x {cfg.nchan} channels "
          f"summed by {nchan_sum}: device alone {device_ms:.5f} ms (a CUDA "
          f"graph of bare launches, L2 warm), through the wrapper "
          f"{wrapper_ms:.5f} ms under CUDA events ({host_ms:.5f} ms of host "
          f"time a call); byte bound {r['bound_ms']:.5f} ms, share "
          f"{r['bound_ms'] / device_ms:.2f} alone, "
          f"{r['bound_ms'] / wrapper_ms:.2f} through the wrapper",
          flush=True)


def print_kernel(card: str, name: str, r: dict, where: str) -> None:
    print(f"[{card}] {name}: kernel {r['ms']:.3f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms (by "
          f"{r['bound_by']}) {where}", flush=True)


def phase_cached(dev, card, results, packed, xc, upper, rand_planes,
                 plain_ms) -> None:
    """``corr_acc(unpack_cache=True)`` at the production shape (tci and
    cti) and a ragged one: exact against the plain version on j >= i and
    bit-identical to the default kernel on every plane."""
    cfg = LWA352
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    ragged = torch.randint(0, 256, (3, 997, 320), generator=g, device=dev,
                           dtype=torch.uint8)
    cti = packed.permute(1, 0, 2).contiguous()
    err = 0.0
    for blk, layout, ni, flag_sets in [
            (packed, "tci", cfg.ninput, [(True, False, False),
                                         (False, True, False),
                                         (True, True, True)]),
            (cti, "cti", cfg.ninput, [(False, True, True)]),
            (ragged, "cti", 300, [(False, True, False)])]:
        view = chan_major(blk, layout, ni)
        nchan = view.shape[0]
        up = torch.triu(torch.ones((ni, ni), dtype=torch.bool, device=dev))
        for flags in flag_sets:
            init = [torch.randint(-2 ** 20, 2 ** 20, (nchan, ni, ni),
                                  generator=g, device=dev, dtype=torch.int32)
                    for _ in range(4)]
            want = [p.clone() for p in init]
            corr_acc_ref(view, Vis(*want[:2]), Vis(*want[2:]), *flags)
            default = [p.clone() for p in init]
            corr_acc(blk, Vis(*default[:2]), Vis(*default[2:]), *flags,
                     layout=layout, unpack_cache=False)
            corr_acc(blk, Vis(*init[:2]), Vis(*init[2:]), *flags,
                     layout=layout, unpack_cache=True)
            torch.cuda.synchronize()
            for a, b, d in zip(init, want, default):
                check(torch.equal(a[:, up], b[:, up]),
                      f"corr_acc cached != plain on j >= i, {layout} {ni} "
                      f"inputs, flags {flags}")
                check(torch.equal(a, d), "corr_acc cached not bit-identical "
                      f"to the default kernel, {layout} flags {flags}")
                err = max(err, max_abs(a[:, up], b[:, up]))
            del init, want, default
        print(f"corr_acc unpack_cache {layout} {ni} inputs x {nchan} "
              f"channels: exact int32 on j >= i, bit-identical to the "
              f"default kernel", flush=True)
    del cti
    state = rand_planes()
    fast, slow = Vis(*state[:2]), Vis(*state[2:])
    ms = cuda_ms(lambda: corr_acc(packed, fast, slow, False, True, False,
                                  unpack_cache=True), 5)
    results["corr_acc_cached"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(*corr_work(cfg.nchan, cfg.acc_len, cfg.ninput, 64, 4, 4)))


def int_mm_yardstick(card: str, packed, nchan: int = 4) -> None:
    """Contraction only: ``torch._int_mm`` on unpacked int8 planes of
    ``nchan`` channels, the four real products re.re, im.im, im.re, re.im
    of the full 704 x 704 matrix each, scaled to the block's channels.  No
    unpack, no triangle, no accumulator algebra: a yardstick for the
    tensor-core contraction, not a library version of the kernel."""
    x = packed[:, :nchan].permute(1, 2, 0).to(torch.int16)   # [c, i, t]
    re = (((x >> 4) ^ 8) - 8).to(torch.int8).contiguous()
    im = (((x & 15) ^ 8) - 8).to(torch.int8).contiguous()

    def products():
        for c in range(nchan):
            for a, b in ((re, re), (im, im), (im, re), (re, im)):
                torch._int_mm(a[c], b[c].t())

    ms = cuda_ms(products, 5) * packed.shape[1] / nchan
    print(f"[{card}] yardstick, contraction only: torch._int_mm, 4 real "
          f"products of [704, 2400] x [2400, 704] int8 per channel, timed "
          f"on {nchan} channels and scaled to {packed.shape[1]}: {ms:.3f} "
          f"ms (no unpack, full matrix, no epilogue)", flush=True)


def beam_cancellation(dev, g) -> None:
    """Y beams nearly equal to X beams times i, so Re(XY*) cancels to ~0
    while XX is large: power and VLBI must still pass the beam gate against
    the float64 plain version."""
    ntime, nchan, ni, nbeam, ntime_sum = 2400, 4, 704, 32, 24
    packed = torch.randint(0, 256, (ntime, nchan, ni), generator=g,
                           device=dev, dtype=torch.uint8)
    gr, gi = (torch.randn((nchan, nbeam, ni), generator=g, device=dev)
              for _ in range(2))
    gr[:, 1::2] = -gi[:, 0::2] + 1e-3 * torch.randn(
        (nchan, nbeam // 2, ni), generator=g, device=dev)
    gi[:, 1::2] = gr[:, 0::2] + 1e-3 * torch.randn(
        (nchan, nbeam // 2, ni), generator=g, device=dev)
    gains = bf.BeamGains(gr, gi)
    p, v = bf.beamform_products(packed, gains, ntime_sum)
    wp, wv = bf.beamform_products_ref(chan_major(packed, "tci"), gains,
                                      ntime_sum)
    torch.cuda.synchronize()
    check(power_close(p, wp) and power_close(v, wv),
          "beam products with cancelling XY* vs plain")
    cross = float(wp[..., 2].abs().max() / wp[..., 0].abs().max())
    print(f"beamform_products, Y = i X + 1e-3 noise (max|Re XY*| / max XX "
          f"= {cross:.1e}): power max|err|/max "
          f"{max_abs(p, wp) / float(wp.abs().max()):.3e}, within the gate",
          flush=True)


def bmm_yardstick(card: str, packed, gains, part: int = 4) -> None:
    """Contraction only: one complex64 ``torch.bmm`` [c, 32, 704] x
    [c, 704, 2400] on voltages unpacked beforehand, timed on 1 / ``part`` of
    the channels and scaled.  No unpack, no power integration, no VLBI."""
    nchan = packed.shape[1]
    n = nchan // part
    xr, xi = bf.unpack(packed[:, :n])
    x = torch.complex(xr.float(), xi.float()).permute(1, 2, 0).contiguous()
    w = torch.complex(gains.real[:n], gains.imag[:n])
    ms = cuda_ms(lambda: torch.bmm(w, x), 5) * nchan / n
    print(f"[{card}] yardstick, contraction only: torch.bmm complex64 "
          f"[{nchan}, {w.shape[1]}, {w.shape[2]}] x [{nchan}, {x.shape[1]}, "
          f"{x.shape[2]}], timed on {n} channels and scaled: {ms:.3f} ms "
          f"(voltages unpacked beforehand, no power, no VLBI)", flush=True)


def rfft_yardstick(card: str, nrow: int, L: int, part: int = 8) -> None:
    """Transform only: ``torch.fft.rfft`` over float32 rows of length
    ``L``, timed on 1 / ``part`` of the rows and scaled.  No FIR, no
    requantizer, and an FFT's operation count, not a matrix DFT's."""
    n = nrow // part
    rows = torch.randn((n, L), device="cuda", dtype=torch.float32)
    ms = cuda_ms(lambda: torch.fft.rfft(rows), 5) * nrow / n
    print(f"[{card}] yardstick, transform only: torch.fft.rfft float32 "
          f"[{nrow}, {L}], timed on {n} rows and scaled: {ms:.3f} ms (no "
          f"FIR, no requantizer)", flush=True)


def matmul_yardstick(card: str, nrow: int, L: int, part: int = 8) -> None:
    """Contraction only: one ``torch.matmul`` of [rows, L] x [L, L] in
    float32 and in float64 (the direct channelizer's DFT as one product of
    the full depth, Re and Im columns side by side), timed on 1 / ``part``
    of the rows and scaled.  No FIR, no fold, no requantizer."""
    n = nrow // part
    for dtype in (torch.float32, torch.float64):
        a = torch.randn((n, L), device="cuda", dtype=dtype)
        b = torch.randn((L, L), device="cuda", dtype=dtype)
        ms = cuda_ms(lambda: torch.matmul(a, b), 5) * nrow / n
        print(f"[{card}] yardstick, contraction only: torch.matmul "
              f"{str(dtype).split('.')[-1]} [{nrow}, {L}] x [{L}, {L}], "
              f"timed on {n} rows and scaled: {ms:.3f} ms (no FIR, no "
              f"requantizer)", flush=True)
        del a, b


def golden_windows(cfg, nwin: int) -> list:
    """The first ``nwin`` golden windows, uint8 [acc_len, nchan, nstand,
    npol] each."""
    return list(golden.generate_input_blocks(
        nwin * cfg.acc_len, cfg.nchan, cfg.nstand, cfg.npol, cfg.acc_len))


def kept_driver(cfg, src, gains_np, pairs, ngulp: int, **kw) -> tuple:
    """The served driver on the card over ``ngulp`` gulps of ``src``, every
    product handed to one ``sink.ProductKeeper`` and each fast dump's
    matrix cloned where the compute thread queues it.  The gains (numpy
    real and imaginary planes) and the input pairs (on the card; None for
    the default selection) are set on the command blocks as a coefficient
    load and a baseline command would leave them; ``kw`` goes to the
    pipeline.  Returns the pipeline, the keeper and the fast matrices."""
    CommandBlock.reset_instance_counts()
    kept = sink.ProductKeeper()
    pipe = XEnginePipeline(cfg, src, sync_time=SYNC_TIME, corr_outputs=[kept],
                           subsel_outputs=[kept], pbeam_outputs=[kept],
                           ibeam_outputs=[kept], device="cuda", **kw)
    pipe.beam_cmd.gains_active[...] = gains_np[0] + 1j * gains_np[1]
    if pairs is not None:
        pipe.subsel_cmd.pairs_device = pairs
    fast = []
    emit = pipe._emit

    def keep_fast(out, t, dec, slow_dec):
        n = pipe.ndump_fast
        emit(out, t, dec, slow_dec)
        if pipe.ndump_fast > n:
            fast.append(Vis(*(p.clone() for p in pipe._dense("fast"))))

    pipe._emit = keep_fast
    pipe.run(ngulp, timeout_s=600)
    torch.cuda.synchronize()
    return pipe, kept, fast


def run_geometry(dev, cfg, blocks: list, gains_np) -> None:
    """Drive the served driver over golden windows; hold every product
    against the plain versions on the card (anchored to the host truth on
    4 channels per window)."""
    ni = cfg.ninput
    nwin = len(blocks)
    gains = bf.BeamGains(*(torch.from_numpy(x).to(dev) for x in gains_np))
    pairs = torch.from_numpy(PAIRS).to(dev)
    pipe, kept, fast = kept_driver(cfg, GoldenSource(cfg, blocks), gains_np,
                                   pairs, nwin * cfg.acc_len // cfg.ntime_gulp)
    starts = [w * cfg.acc_len for w in range(nwin)]
    check(list(kept.vlbi) == starts and len(fast) == nwin,
          f"{cfg.nchan}c: step calls at {list(kept.vlbi)}, {len(fast)} fast "
          f"dumps, for {nwin} windows")
    slow_plain = None
    for w, (block, t) in enumerate(zip(blocks, starts)):
        packed = torch.from_numpy(block.reshape(cfg.acc_len, cfg.nchan,
                                                ni)).to(dev)
        xc = chan_major(packed, "tci")
        plain = correlate_chan_major(xc)
        hvr, hvi = golden.host_corr_int32(block[:, :4])
        check(np.array_equal(plain.real[:4].cpu().numpy(), hvr)
              and np.array_equal(plain.imag[:4].cpu().numpy(), hvi),
              "plain correlator vs host truth on 4 channels")
        check(vis_equal(fast[w], plain),
              f"{cfg.nchan}c window {w}: fast dump vs plain")
        want = cs.corr_subsel_ref(plain, pairs, cfg.nchan_sum)
        check(np.array_equal(kept.subsel[t][0], want.real.cpu().numpy())
              and np.array_equal(kept.subsel[t][1], want.imag.cpu().numpy()),
              f"{cfg.nchan}c window {w}: subsel vs plain")
        wp, wv = bf.beamform_products_ref(xc, gains, cfg.ntime_sum)
        check(np.array_equal(kept.vlbi[t], wv.cpu().numpy()),
              f"{cfg.nchan}c window {w}: VLBI not exact")
        check(power_close(torch.from_numpy(kept.power[t]), wp.cpu()),
              f"{cfg.nchan}c window {w}: beam power vs plain")
        slow_plain = plain if slow_plain is None else slow_plain + plain
        print(f"[driver {cfg.nchan}c] window {w}: fast, subsel, VLBI exact; "
              f"power within rtol 1e-4", flush=True)
        del packed, xc, plain
    del fast
    check(list(kept.slow) == [0] and pipe.ndump_slow == 1,
          f"{cfg.nchan}c: slow dumps at {list(kept.slow)}")
    sr, si = kept.slow[0]
    check(np.array_equal(sr, slow_plain.real.cpu().numpy())
          and np.array_equal(si, slow_plain.imag.cpu().numpy()),
          f"{cfg.nchan}c: slow dump vs plain")
    print(f"[driver {cfg.nchan}c] slow dump after {nwin} windows: exact",
          flush=True)


def zero_counts() -> None:
    for spec in KERNELS.values():
        setattr(spec["fn"], spec.get("counter", "launches"), 0)


def read_counts() -> dict:
    return {name: getattr(spec["fn"], spec.get("counter", "launches"))
            for name, spec in KERNELS.items()}


def pfb_gate(packed, adc, window, nchan: int, ntap: int, scale,
             fast: bool = False, what: str = "") -> int:
    """Kernel bytes vs the float64 plain channelizer (run in chunks of
    inputs: its FIR alone would be 5.2 GB at 704 inputs).  Every differing nibble
    must be a one-code step at a threshold; their count must be <= 1e-6 of
    the codes (1e-5 for bf16 operands).  Returns that count."""
    tolerated = pfb.assert_packed_matches_ref(packed, adc, window, nchan,
                                              ntap, scale, fast)
    ncode = 2 * packed.numel()
    frac = tolerated / ncode
    print(f"{what}: pfb gate {tolerated} threshold cases of {ncode} codes "
          f"({frac:.2e})", flush=True)
    check(frac <= (1e-5 if fast else 1e-6), f"{what}: pfb gate {frac:.2e}")
    return tolerated


def code_histogram(packed, what: str) -> None:
    """A noise window's codes must not be degenerate: at most 5% saturated
    (-8 or 7) and at least 12 of the 16 codes in use."""
    counts = torch.zeros(16, dtype=torch.int64, device=packed.device)
    for nib in (packed >> 4, packed & 0xF):
        counts += torch.bincount(nib.flatten().to(torch.int32),
                                 minlength=16)
    sat = float(counts[7] + counts[8]) / float(counts.sum())
    used = int((counts > 0).sum())
    print(f"{what}: {sat:.4f} of codes saturated, {used} of 16 codes used",
          flush=True)
    check(sat <= 0.05 and used >= 12, f"{what}: degenerate code histogram")


def fx_scale_for(adc: np.ndarray, cfg) -> float:
    """The requant gain that puts the pre-quantization rms near 2.5 codes,
    from the first 8 inputs."""
    x = torch.from_numpy(adc[:, :8].copy())
    re, _ = pfb.pfb_prequant_ref(x, pfb.pfb_window(cfg.nchan, cfg.pfb_ntap),
                                 cfg.nchan, cfg.pfb_ntap, 1.0)
    return float(np.float32(2.5 / float(re.std())))


def adc_windows(cfg, nwin: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    n = cfg.acc_len * 2 * cfg.nchan
    return [rng.integers(-90, 91, (n, cfg.ninput), dtype=np.int8)
            for _ in range(nwin)]


def drive_fx(dev, cfg, windows: list, gains_np, quant_scale: float):
    """One FX path run: counts to 0, the served driver in FX mode over the
    windows, counts read.  Records per window the ADC behind the FIR
    history it goes up with (zeros, then the window before's last
    frames), the products (the slow dump with the last window's) and the
    fast matrix."""
    zero_counts()
    gains_np = [x[:cfg.nchan] for x in gains_np]
    pipe, kept, fast = kept_driver(
        cfg, AdcWindowSource(cfg, windows), gains_np,
        torch.from_numpy(PAIRS).to(dev),
        len(windows) * cfg.acc_len // cfg.ntime_gulp, fx_mode=True,
        quant_scale=quant_scale)
    counts = read_counts()
    starts = [w * cfg.acc_len for w in range(len(windows))]
    check(list(kept.vlbi) == starts and len(fast) == len(windows),
          f"FX driver: step calls at {list(kept.vlbi)}, {len(fast)} fast "
          f"dumps, for {len(windows)} windows")
    k = pipe._adc_tail.shape[0]
    tail = np.zeros((k, cfg.ninput), windows[0].dtype)
    records = []
    for adc, t, vis in zip(windows, starts, fast):
        prod = {"subsel": kept.subsel[t], "vlbi": kept.vlbi[t],
                "bf_power": kept.power[t]}
        records.append((np.concatenate([tail, adc]), prod, vis))
        tail = adc[len(adc) - k:]
    check(np.array_equal(pipe._adc_tail, tail),
          "FX driver: the FIR history after the run is not the last "
          "window's last frames")
    if list(kept.slow) == [0]:
        records[-1][1]["vis_slow"] = kept.slow[0]
    gains = bf.BeamGains(*(torch.from_numpy(x).to(dev) for x in gains_np))
    return records, gains, pipe.feng_cmd.scale_device, counts


def check_fx(dev, cfg, records, gains, scale, label: str,
             noise: bool = True) -> list:
    """(a) the channelizer's bytes under the gate, (b) fast, subselection,
    VLBI (integer gains) and slow exact and power within rtol 1e-4 against
    the plain X/B versions on those bytes, (c) the code histogram of noise
    windows.  Returns the kernel's bytes per window (input-major)."""
    window = torch.from_numpy(pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)).to(dev)
    pairs = torch.from_numpy(PAIRS).to(dev)
    slow_plain, out = None, []
    for w, (ext, prod, dense) in enumerate(records):
        what = f"[FX {label}] window {w}"
        adc = torch.from_numpy(ext).to(dev)
        # the kernel the driver's window took (``channelizer(cfg)``)
        packed = pfb_fused.pfb_quantize_packed(
            adc, window, cfg.nchan, cfg.pfb_ntap, scale,
            cfg.pfb_precision == "bf16")
        pfb_gate(packed, adc, window, cfg.nchan, cfg.pfb_ntap, scale,
                 what=what)
        if noise:
            code_histogram(packed, what)
        xc = chan_major(packed.permute(1, 2, 0).contiguous(), "tci")
        plain = correlate_chan_major(xc)
        check(vis_equal(dense, plain),
              f"{what}: fast dump vs plain on the kernel's bytes")
        want = cs.corr_subsel_ref(plain, pairs, cfg.nchan_sum)
        check(np.array_equal(prod["subsel"][0], want.real.cpu().numpy())
              and np.array_equal(prod["subsel"][1], want.imag.cpu().numpy()),
              f"{what}: subsel vs plain")
        wp, wv = bf.beamform_products_ref(xc, gains, cfg.ntime_sum)
        check(np.array_equal(prod["vlbi"], wv.cpu().numpy()),
              f"{what}: VLBI not exact")
        check(power_close(torch.from_numpy(prod["bf_power"]), wp.cpu()),
              f"{what}: beam power vs plain")
        slow_plain = plain if slow_plain is None else slow_plain + plain
        print(f"{what}: fast, subsel, VLBI exact; power within rtol 1e-4",
              flush=True)
        out.append(packed)
        del adc, xc, plain
    check("vis_slow" in prod, f"[FX {label}]: no slow dump")
    sr, si = prod["vis_slow"]
    check(np.array_equal(sr, slow_plain.real.cpu().numpy())
          and np.array_equal(si, slow_plain.imag.cpu().numpy()),
          f"[FX {label}]: slow dump vs plain")
    print(f"[FX {label}] slow dump after {len(records)} windows: exact",
          flush=True)
    return out


def run_fx_path(dev, gains_np) -> tuple[dict, float]:
    """The FX path: 3 int8 windows + slow dump at 192 channels, one window
    at 184, one with float32 ADC, one tone window.  Returns the launch
    counts summed over the runs and the requant gain."""
    cfg = FX_CFG
    windows = adc_windows(cfg, 3, SEED)
    runs = []

    def run(cfg_r, wins, label, noise=True, qs=None):
        if qs is None:
            qs = fx_scale_for(wins[0], cfg_r)
        print(f"[FX {label}] requant gain {qs:.6g} (pre-quantization rms "
              f"~2.5 codes on noise)", flush=True)
        records, gains, scale, counts = drive_fx(dev, cfg_r, wins, gains_np,
                                                 qs)
        for name in (channelizer(cfg_r), DEFAULT_CORR, "beamform_products",
                     "subsel_gather"):
            check(counts[name] > 0, f"[FX {label}] {name} not launched")
        print(f"[FX {label}] kernel launches: {counts}", flush=True)
        runs.append(counts)
        return check_fx(dev, cfg_r, records, gains, scale, label, noise), \
            records

    bytes8, rec8 = run(cfg, windows, "192c int8")
    cfg184 = LWA352.replace(nchan=184, adc_dtype="int8", acc_len_slow=cfg.acc_len)
    run(cfg184, adc_windows(cfg184, 1, SEED + 2), "184c int8")
    cfg32 = cfg.replace(adc_dtype="float32", acc_len_slow=cfg.acc_len)
    bytes32, rec32 = run(cfg32, [windows[0].astype(np.float32)], "192c f32")
    check(torch.equal(bytes32[0], bytes8[0]),
          "f32 ADC bytes differ from the int8 run's on the same values")
    check(all(torch.equal(a, b) for a, b in zip(rec32[0][2], rec8[0][2])),
          "f32 ADC fast dump differs from the int8 run's")
    print("[FX 192c f32] packed bytes and fast dump equal the int8 run's",
          flush=True)
    del bytes8, bytes32, rec8, rec32
    cfgt = cfg.replace(acc_len_slow=cfg.acc_len)
    src = ADCSource(cfgt, mode="tone", tone_chan=TONE_CHAN, amplitude=32.0)
    tone = np.concatenate([src.gulp(i) for i in range(
        cfgt.acc_len // cfgt.ntime_gulp)])
    _, rect = run(cfgt, [tone], f"tone {TONE_CHAN}", noise=False,
                  qs=fx_scale_for(windows[0], cfg))
    sr, _ = rect[-1][1]["vis_slow"]
    autos = sr[:, 0, 0].astype(np.float64)
    others = np.delete(autos, [TONE_CHAN - 1, TONE_CHAN, TONE_CHAN + 1])
    check(int(autos.argmax()) == TONE_CHAN
          and others.max() < 0.05 * autos[TONE_CHAN]
          and np.allclose(sr[TONE_CHAN], autos[TONE_CHAN], rtol=0.01),
          f"tone not in channel {TONE_CHAN}")
    print(f"[FX tone] the tone lands in channel {TONE_CHAN} (auto "
          f"{autos[TONE_CHAN]:.0f}, largest elsewhere {others.max():.0f})",
          flush=True)
    total = {name: sum(r[name] for r in runs) for name in KERNELS}
    return total, fx_scale_for(windows[0], cfg)


def run_fengine(dev, card: str, results: dict) -> dict:
    """The F-engine path: channelize_pack_imajor at 4096 channels x 704
    inputs x 240 spectra of int8 ADC (1.4 GB; depth cut from 2400 spectra
    for the time limit), the factored kernel against the plain version."""
    cfg = LWA352.replace(nchan=FENGINE_NCHAN, adc_dtype="int8")
    ntap, L = cfg.pfb_ntap, 2 * FENGINE_NCHAN
    rng = np.random.default_rng(SEED + 3)
    adc_np = rng.integers(-90, 91, ((FENGINE_NSPEC + ntap - 1) * L,
                                    cfg.ninput), dtype=np.int8)
    qs = fx_scale_for(adc_np, cfg)
    adc = torch.from_numpy(adc_np).to(dev)
    del adc_np
    window = torch.from_numpy(pfb.pfb_window(FENGINE_NCHAN, ntap)).to(dev)
    zero_counts()
    packed = pfb.channelize_pack_imajor(adc, window, cfg, qs)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["pfb_factored"] > 0, "F-engine: pfb_factored not launched")
    print(f"[F-engine] kernel launches: {counts}", flush=True)
    check(packed.shape == (cfg.ninput, FENGINE_NSPEC, FENGINE_NCHAN),
          "F-engine: packed shape")
    what = f"[F-engine {FENGINE_NCHAN}c x {cfg.ninput} x {FENGINE_NSPEC}]"
    ntol = pfb_gate(packed, adc, window, FENGINE_NCHAN, ntap, qs, what=what)
    code_histogram(packed, what)
    # float32 ADC of equal values (64 inputs, a strided view) gives the
    # int8 run's bytes; bf16 operands pass their own gate at full size
    sub = pfb_fused.pfb_factored(adc[:, :64].float(), window, FENGINE_NCHAN,
                                 ntap, qs)
    check(torch.equal(sub, packed[:64]),
          "F-engine: float32 ADC bytes != int8 ADC bytes")
    del sub
    fast = pfb_fused.pfb_factored(adc, window, FENGINE_NCHAN, ntap, qs,
                                  fast=True)
    torch.cuda.synchronize()
    pfb_gate(fast, adc, window, FENGINE_NCHAN, ntap, qs, fast=True,
             what=what + " bf16")
    del fast
    ms = cuda_ms(lambda: pfb_fused.pfb_factored(adc, window, FENGINE_NCHAN,
                                                ntap, qs), 3)
    plain_ms = cuda_ms(lambda: pfb.pfb_quantize_packed_ref(
        adc, window, FENGINE_NCHAN, ntap, qs), 1)
    results["pfb_factored"].update(
        max_abs_err=1.0 if ntol else 0.0, ms=ms, plain_ms=plain_ms,
        **bound(*pfb_work(adc.numel() * adc.element_size(), adc.shape[1],
                          FENGINE_NSPEC, FENGINE_NCHAN, ntap)))
    msps = FENGINE_NSPEC * L / (ms * 1e-3) / 1e6
    print(f"[{card}] pfb_factored at {FENGINE_NCHAN} channels x "
          f"{cfg.ninput} inputs x {FENGINE_NSPEC} spectra: kernel {ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms, bound "
          f"{results['pfb_factored']['bound_ms']:.3f} ms (by "
          f"{results['pfb_factored']['bound_by']}); {msps:.1f} Msamples/s "
          f"per input "
          f"(F-engine bar fs = {cfg.fs_hz / 1e6:.0f} Msamples/s: "
          f"{msps / (cfg.fs_hz / 1e6):.3f}x)", flush=True)
    del adc, packed
    rfft_yardstick(card, cfg.ninput * FENGINE_NSPEC, L)
    return counts


def phase_pfb_direct(dev, card: str, results: dict) -> None:
    """The direct channelizer kernel against its plain version at the
    production shape (704 inputs x 2400 spectra x 192 channels, int8),
    float32 and bf16 operands, and per-channel scale."""
    cfg = FX_CFG
    ntap, L = cfg.pfb_ntap, 2 * cfg.nchan
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    adc = torch.randint(-90, 91, ((cfg.acc_len + ntap - 1) * L, cfg.ninput),
                        generator=g, device=dev, dtype=torch.int8)
    window = torch.from_numpy(pfb.pfb_window(cfg.nchan, ntap)).to(dev)
    qs = fx_scale_for(adc[:, :8].cpu().numpy(), cfg)
    per_chan = (torch.rand(cfg.nchan, generator=g, device=dev) * 0.6
                + 0.7) * qs
    ntol = 0
    for scale, fast, what in [(qs, False, "float32"),
                              (per_chan, False, "float32, per-channel"),
                              (qs, True, "bf16")]:
        packed = pfb_fused.pfb_direct(adc, window, cfg.nchan, ntap, scale,
                                      fast)
        torch.cuda.synchronize()
        n = pfb_gate(packed, adc, window, cfg.nchan, ntap, scale, fast,
                     what=f"pfb_direct {what}")
        ntol += 0 if fast else n
    results["pfb_direct"].update(
        **bound(*pfb_work(adc.numel() * adc.element_size(), adc.shape[1],
                          cfg.acc_len, cfg.nchan, ntap)),
        max_abs_err=1.0 if ntol else 0.0,
        ms=cuda_ms(lambda: pfb_fused.pfb_direct(adc, window, cfg.nchan, ntap,
                                                qs), 5),
        plain_ms=cuda_ms(lambda: pfb.pfb_quantize_packed_ref(
            adc, window, cfg.nchan, ntap, qs), 2))
    print_kernel(card, "pfb_direct", results["pfb_direct"],
                 "per 2400-spectra window at 704 inputs")
    matmul_yardstick(card, cfg.ninput * cfg.acc_len, L)


def phase_pfb_fft(dev, card: str, results: dict) -> None:
    """The FFT channelizer kernel against its plain version at the
    production shape (704 inputs x 2400 spectra x 192 channels, int8),
    scalar and per-channel scale, and its bytes against the direct
    kernel's (a differing nibble must be a one-code step at a threshold)."""
    cfg = FX_CFG
    ntap = cfg.pfb_ntap
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    adc = torch.randint(-90, 91, ((cfg.acc_len + ntap - 1) * 2 * cfg.nchan,
                                  cfg.ninput),
                        generator=g, device=dev, dtype=torch.int8)
    window = torch.from_numpy(pfb.pfb_window(cfg.nchan, ntap)).to(dev)
    qs = fx_scale_for(adc[:, :8].cpu().numpy(), cfg)
    per_chan = (torch.rand(cfg.nchan, generator=g, device=dev) * 0.6
                + 0.7) * qs
    ntol = ndirect = 0
    for scale, what in [(qs, "float32"), (per_chan, "float32, per-channel")]:
        packed = pfb_fused.pfb_fft(adc, window, cfg.nchan, ntap, scale)
        direct = pfb_fused.pfb_direct(adc, window, cfg.nchan, ntap, scale)
        torch.cuda.synchronize()
        ntol += pfb_gate(packed, adc, window, cfg.nchan, ntap, scale,
                         what=f"pfb_fft {what}")
        for sl, pre, _ in pfb._ref_chunks(adc, window, cfg.nchan, ntap,
                                          scale, False):
            ndirect += pfb.assert_packed_close(packed[sl], direct[sl], pre)
    print(f"[{card}] pfb_fft: {ndirect} of {4 * packed.numel()} nibbles "
          "differ from pfb_direct's, each at a threshold", flush=True)
    results["pfb_fft"].update(
        **bound(*pfb_work(adc.numel() * adc.element_size(), adc.shape[1],
                          cfg.acc_len, cfg.nchan, ntap)),
        max_abs_err=1.0 if ntol else 0.0,
        ms=cuda_ms(lambda: pfb_fused.pfb_fft(adc, window, cfg.nchan, ntap,
                                             qs), 5),
        plain_ms=cuda_ms(lambda: pfb.pfb_quantize_packed_ref(
            adc, window, cfg.nchan, ntap, qs), 2))
    print_kernel(card, "pfb_fft", results["pfb_fft"],
                 "per 2400-spectra window at 704 inputs")
    ptxas_report(card, {"pfb_fft_kernel": 6})


def ptxas_report(card: str, kernels: dict) -> None:
    """The compiler's report (registers, spills, static shared memory) of
    each of ``kernels`` (names of __global__ functions, each with the
    number of its template instantiations), from the log the build keeps
    beside the library."""
    log = _build.BUILD_DIR / f"libcbd_kernels_{_build.source_hash()}.log"
    lines = log.read_text().splitlines()
    for kernel, count in kernels.items():
        starts = [k for k, line in enumerate(lines)
                  if "Compiling entry function" in line and kernel in line]
        check(len(starts) == count, f"ptxas report of {kernel}: "
              f"{len(starts)} entries, not {count}")
        for start in starts:
            report = []
            for line in lines[start + 1:]:
                if "Compiling entry function" in line:
                    break
                if "registers" in line or "spill" in line:
                    report.append(line.split(":", 1)[-1].strip())
            args = re.search(r"ILi(\d+)EE", lines[start])
            name = kernel + (f"<{args.group(1)}>" if args else "")
            print(f"[{card}] ptxas {name}: {'; '.join(report)}", flush=True)


def phase_triu(dev, card: str, results: dict) -> None:
    """The three gulp correlators against their plain versions."""
    ptxas_report(card, {"corr_triu_kernel": 1, "corr_rows_kernel": 1})
    phase_gulp(dev, card, results, "corr_triu", corr_triu, corr_triu_ref,
               TILE)
    phase_gulp(dev, card, results, "corr_blk", cblk.corr_blk,
               cblk.corr_blk_ref, cblk.TILE)
    phase_gulp(dev, card, results, "corr_rows", crows.corr_rows,
               crows.corr_rows_ref, crows.TILE)


def gulp_block(kind: str, shape: tuple, layout: str, g, dev):
    """A packed block of ``shape`` in ``layout``: random bytes, all 0x88
    (both nibbles -8, the widest products), or structured (a distinct byte
    per input and time sample, so a wrong fragment or transpose map cannot
    hide in noise)."""
    if kind == "random":
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.uint8)
    if kind == "widest":
        return torch.full(shape, 0x88, dtype=torch.uint8, device=dev)
    a, b, i = (torch.arange(n, device=dev) for n in shape)
    t, c = (a, b) if layout == "tci" else (b, a)
    view = {"tci": ((-1, 1, 1), (1, -1, 1)), "cti": ((1, -1, 1), (-1, 1, 1))}
    t, c = t.reshape(view[layout][0]), c.reshape(view[layout][1])
    return ((i * 7 + t * 13 + c * 29) % 256).to(torch.uint8)


def phase_gulp(dev, card: str, results: dict, name: str, fn, ref,
               tile_size: int) -> None:
    """A gulp correlator against its plain version: random bytes at the
    production shape in both layouts and at a ragged shape (300 inputs, 997
    spectra, padded cti); the two kernels that unpack their own tiles
    (``corr_triu``, ``corr_rows``) also on structured and all-0x88 blocks at
    the production shape.  Exact int32 on the upper tiles, zero below
    them."""
    cfg = LWA352
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    err = 0.0
    cases = [("random", cfg.acc_len, cfg.nchan, cfg.ninput, "tci", 0),
             ("random", cfg.acc_len, cfg.nchan, cfg.ninput, "cti", 64),
             ("random", 997, 3, 300, "cti", 20)]
    if name in ("corr_triu", "corr_rows"):
        cases += [("structured", cfg.acc_len, cfg.nchan, cfg.ninput, "tci", 0),
                  ("widest", cfg.acc_len, cfg.nchan, cfg.ninput, "cti", 64)]
    for kind, ntime, nchan, ni, layout, pad in cases:
        shape = ((ntime, nchan, ni) if layout == "tci"
                 else (nchan, ntime, ni + pad))
        packed = gulp_block(kind, shape, layout, g, dev)
        got = fn(packed, layout, ni)
        want = ref(chan_major(packed, layout, ni))
        torch.cuda.synchronize()
        tile = torch.arange(ni, device=dev) // tile_size
        valid = tile[:, None] <= tile[None, :]
        for a, b in zip(got, want):
            check(torch.equal(a[:, valid], b[:, valid]),
                  f"{name} != plain on the upper tiles ({ni} inputs, "
                  f"{ntime} spectra, {layout})")
            check(not a[:, ~valid].any(), f"{name} wrote below the "
                  "diagonal tiles")
            err = max(err, max_abs(a[:, valid], b[:, valid]))
        print(f"{name} {kind} {ni} inputs x {nchan} channels x {ntime} "
              f"spectra {layout}: exact int32 on the upper {tile_size}-tiles",
              flush=True)
        if kind == "random" and ni == cfg.ninput and layout == "tci":
            xc = chan_major(packed, layout, ni)
            results[name].update(
                ms=cuda_ms(lambda: fn(packed, layout, ni), 5),
                plain_ms=cuda_ms(lambda: ref(xc), 2),
                **bound(*corr_work(nchan, ntime, ni, tile_size, 0, 2)))
            if name in ("corr_triu", "corr_rows"):
                # one call per gulp, as the driver's pallas_triu step and
                # the schedules run call them
                gulps = [packed[t:t + cfg.ntime_gulp]
                         for t in range(0, ntime, cfg.ntime_gulp)]
                gulp_ms = cuda_ms(lambda: [fn(x, layout, ni) for x in gulps],
                                  5)
                print(f"[{card}] {name}: {len(gulps)} calls of "
                      f"{cfg.ntime_gulp} spectra, one per gulp: {gulp_ms:.3f} "
                      f"ms per window (one call over the window: "
                      f"{results[name]['ms']:.3f} ms)", flush=True)
        del got, want
    results[name]["max_abs_err"] = err
    print_kernel(card, name, results[name], "per 2400-spectra window at 704 "
                 "inputs x 192 channels")


class GoldenSource(SyntheticSource):
    """The golden stream gulp by gulp from pre-generated windows, or a
    recorder file's frames, from spectra index ``seq0`` on, for the
    driver's zero-copy ingest (``fill_into``)."""

    def __init__(self, cfg, blocks, seq0: int = 0):
        super().__init__(cfg)
        g = cfg.ntime_gulp
        self.seq0 = seq0
        self.gulps = [b.reshape(-1, cfg.nchan, cfg.ninput)[k:k + g]
                      for b in blocks for k in range(0, len(b), g)]

    def fill_into(self, dest):
        i = self._fill_i
        self._fill_i += 1
        dest.reshape(self.gulps[i].shape)[...] = self.gulps[i]
        return self.seq0 + i * self.cfg.ntime_gulp

    def stream(self, ngulp: int, seq0: int = 0):
        for i in range(ngulp):
            yield seq0 + i * self.cfg.ntime_gulp, self.gulps[i]


class Receiver(threading.Thread):
    """A loopback UDP receiver: every datagram until stopped."""

    def __init__(self):
        super().__init__(daemon=True)
        self.sock = sink.udp_rx_socket("127.0.0.1", 0, rcvbuf_mb=256,
                                       timeout_s=0.2)
        force = getattr(socket, "SO_RCVBUFFORCE", None)
        if force is not None:
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, force, 256 << 20)
            except PermissionError:
                pass  # capped at the host's rmem_max; the size is printed
        self.rcvbuf = self.sock.getsockopt(socket.SOL_SOCKET,
                                           socket.SO_RCVBUF)
        self.addr = self.sock.getsockname()
        self.pkts = []
        self.done = threading.Event()

    def run(self):
        while True:
            try:
                self.pkts.append(self.sock.recv(65536))
            except TimeoutError:
                if self.done.is_set():
                    return

    def stop(self) -> list:
        self.done.set()
        self.join()
        self.sock.close()
        return self.pkts


def driver_truth(dev, cfg, blocks, gains, pairs) -> tuple[list, tuple]:
    """Plain products of each driver window on the card (anchored to the
    host truth on 4 channels) and the plain slow dump over all of them."""
    gr, gi = (x.cpu().numpy() for x in gains)
    truth, slow = [], None
    for w, block in enumerate(blocks):
        packed = torch.from_numpy(block.reshape(cfg.acc_len, cfg.nchan,
                                                cfg.ninput)).to(dev)
        xc = chan_major(packed, "tci")
        plain = correlate_chan_major(xc)
        hvr, hvi = golden.host_corr_int32(block[:, :4])
        check(np.array_equal(plain.real[:4].cpu().numpy(), hvr)
              and np.array_equal(plain.imag[:4].cpu().numpy(), hvi),
              "driver truth: plain correlator vs host on 4 channels")
        sub = cs.corr_subsel_ref(plain, pairs, cfg.nchan_sum)
        wp, wv = bf.beamform_products_ref(xc, gains, cfg.ntime_sum)
        br, bi = golden.host_beams(block[:, :4], gr[:4], gi[:4])
        hv = np.stack([br[:, :2], bi[:, :2]], -1).transpose(2, 0, 1, 3)
        check(np.array_equal(wv[:, :4].cpu().numpy(), hv)
              and power_close(wp[:, :, :4].cpu(), torch.from_numpy(
                  golden.host_power(br, bi, cfg.ntime_sum)).float()),
              "driver truth: plain beams vs host on 4 channels")
        truth.append({"sub": (sub.real.cpu().numpy(),
                              sub.imag.cpu().numpy()),
                      "power": wp.cpu(), "vlbi": wv.cpu().numpy()})
        slow = plain if slow is None else slow + plain
        del packed, xc
    return truth, (slow.real.cpu().numpy(), slow.imag.cpu().numpy())


def command(store, key: str, seq, **kwargs) -> None:
    """One control-plane command through the store (the client's
    envelope)."""
    store.put(key, json.dumps({"cmd": "update", "id": seq,
                               "val": {"kwargs": kwargs}}))


def load_gains(pipe, store, gains_np) -> None:
    """Every (beam, input) calibration gain, then a zero-delay unit-amp
    load of every beam: the active gains equal ``gains_np`` exactly."""
    gr, gi = gains_np
    key = pipe.beam_cmd.command_key
    data = np.empty(2 * gr.shape[0])
    for b in range(gr.shape[1]):
        for i in range(gr.shape[2]):
            data[0::2] = gr[:, b, i]
            data[1::2] = gi[:, b, i]
            command(store, key, f"g{b}.{i}", coeffs={
                "type": "calgains", "input_id": i, "beam_id": b,
                "data": data.tolist()})
    ni = gr.shape[2]
    for b in range(gr.shape[1]):
        command(store, key, f"d{b}", coeffs={
            "type": "beamcoeffs", "beam_id": b, "load_sample": -1,
            "data": {"delays": [0.0] * ni, "amps": [1.0] * ni}})


def decode_streams(cfg, sub_pkts, pb_pkts, ib_pkts, nwin: int):
    """Received packets -> per-window subselection planes (with the
    baselines they carried), power [nbeam//2, nblock, nchan, 4] and VLBI
    [ntime, nchan, 2, 2]."""
    nco = cfg.nchan // cfg.nchan_sum
    subs = {}
    for p in sub_pkts:
        hdr, bl, data = pk.decode_corr_part(p)
        subs.setdefault(hdr.spectra_id, []).append((bl, data))
    windows = []
    for w in range(nwin):
        parts = subs.get(w * cfg.acc_len, [])
        bl = np.concatenate([b for b, _ in parts]) if parts else None
        data = (np.concatenate([d for _, d in parts]) if parts
                else np.zeros((0, nco, 2), np.int32))
        windows.append((bl, data[..., 0].T, data[..., 1].T))
    nblock = nwin * cfg.acc_len // cfg.ntime_sum
    power = np.full((cfg.nbeam // 2, nblock, cfg.nchan, 4), np.nan,
                    np.float32)
    for p in pb_pkts:
        hdr, data = pk.decode_pbeam(p)
        power[hdr.beam - 1, hdr.seq // cfg.ntime_sum] = data[:, 0]
    vlbi = np.full((nwin * cfg.acc_len, cfg.nchan, 2, 2), np.nan,
                   np.float32)
    for p in ib_pkts:
        hdr, data = pk.decode_ibeam(p)
        vlbi[hdr.seq] = data
    return windows, power, vlbi


def packet_digests(streams: dict) -> dict:
    """SHA-256 of each sink's packets, taken in sorted order (loopback UDP
    keeps no order between senders): equal digests mean the same packets
    byte for byte."""
    out = {}
    for name, pkts in streams.items():
        h = hashlib.sha256()
        for p in sorted(bytes(p) for p in pkts):
            h.update(len(p).to_bytes(4, "little"))
            h.update(p)
        out[name] = h.hexdigest()
    return out


class DriverRun:
    """What one driver run gives back: the launch counts, the digest of
    each sink's packets, the wall time, the host time of each window and
    the sustained rate."""

    def __init__(self, counts, digests, wall, per_window, gbps):
        self.counts = counts
        self.digests = digests
        self.wall = wall
        self.per_window = per_window
        self.gbps = gbps


def run_driver(dev, card: str, label: str, engines: dict, blocks,
               gains_np, truth, slow, mesh=None, cor_mbps=None,
               capture=None, fast=None) -> DriverRun:
    """One driver run: launch counts to 0, XEnginePipeline over the
    golden windows with every sink (sharded over ``mesh`` if given),
    counts read, products checked.

    ``cor_mbps`` (a rate cap, -1 for none): the COR slow dump goes through
    the C++ packetizer (``native_dest``) to a receiver in a process of its
    own.  ``capture``: a :class:`Blaster` sends the windows as snap2
    packets to a ``native.CaptureSource``, the run's source.  ``fast``:
    the plain fast dump of each window on the card, held against the
    pipeline's at each dump."""
    cfg = DRIVER_CFG.replace(**engines)
    nwin = len(blocks)
    nbl = cfg.nstand * (cfg.nstand + 1) // 2
    CommandBlock.reset_instance_counts()
    rx = {name: Receiver() for name in ("subsel", "pbeam", "ibeam")}
    for r in rx.values():
        r.start()
    cor, cor_rx = [], None
    if cor_mbps is None:
        corr_out = sink.CorrFullOutput(cfg, send=cor.append, use_cor_fmt=True)
    else:
        cor_rx = CorReceiver(nbl, cor_packet_size(cfg))
        corr_out = sink.CorrFullOutput(cfg, native_dest=cor_rx.addr,
                                       max_mbps=cor_mbps, use_cor_fmt=True)
    src = GoldenSource(cfg, blocks) if capture is None else capture.source
    store = MemoryStore()
    pipe = XEnginePipeline(
        cfg, src, store=store, sync_time=SYNC_TIME,
        corr_outputs=[corr_out],
        subsel_outputs=[sink.CorrPartOutput(
            cfg, send=sink.UdpSender(*rx["subsel"].addr))],
        pbeam_outputs=[sink.PBeamOutput(
            cfg, senders={b: sink.UdpSender(*rx["pbeam"].addr)
                          for b in range(cfg.nbeam // 2)})],
        ibeam_outputs=[sink.IBeamOutput(
            cfg, send=sink.UdpSender(*rx["ibeam"].addr))],
        mesh=mesh, device="cuda")
    fast_ok = []
    if fast is not None:
        emit = pipe._emit

        def checked_emit(out, t, dec, slow_dec):
            n = pipe.ndump_fast
            emit(out, t, dec, slow_dec)
            if pipe.ndump_fast > n:
                got, want = pipe._dense("fast"), fast[dec.seq0 // cfg.acc_len]
                fast_ok.append(torch.equal(got.real, want.real)
                               and torch.equal(got.imag, want.imag))

        pipe._emit = checked_emit
    t0 = time.perf_counter()
    load_gains(pipe, store, gains_np)
    command(store, pipe.subsel_cmd.command_key, "bl",
            baselines=DRIVER_BASELINES)
    print(f"[driver {label}] gains and baselines commanded in "
          f"{time.perf_counter() - t0:.1f} s; receive buffers "
          f"{min(r.rcvbuf for r in rx.values())} B", flush=True)
    ngulp = nwin * cfg.acc_len // cfg.ntime_gulp
    zero_counts()
    t0 = time.perf_counter()
    if capture is not None:
        capture.go()
    try:
        pipe.run(ngulp, timeout_s=600 if capture is None else 240)
    except TimeoutError:
        if capture is not None:
            print(f"[driver {label}] stalled after {pipe.ndump_fast} fast "
                  f"dumps; {capture.status()}", flush=True)
            faulthandler.dump_traceback(sys.stdout)
        raise
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    missing = None
    if capture is not None:
        try:
            capture.finish(f"driver {label}")
        except PacketsMissing as e:
            missing = e
        finally:
            src.close()
    if cor_rx is not None:
        cor = cor_rx.collect()
    sub_pkts, pb_pkts, ib_pkts = (rx[n].stop() for n in
                                  ("subsel", "pbeam", "ibeam"))
    if missing is not None:
        raise missing
    print(f"[driver {label}] kernel launches: {counts}", flush=True)
    correlator = {"pallas_triu": "corr_triu", "pallas_blk": (
        DEFAULT_CORR if mesh is None else "corr_blk")}[engines["corr_engine"]]
    for name in (correlator, "subsel_gather", "beamform_products"):
        check(counts[name] > 0, f"[driver {label}] {name} not launched")
    check((pipe.ndump_fast, pipe.ndump_slow) == (nwin, 1),
          f"[driver {label}] dumps {pipe.ndump_fast} fast, "
          f"{pipe.ndump_slow} slow")
    if fast is not None:
        check(fast_ok == [True] * nwin,
              f"[driver {label}] fast dumps vs plain: {fast_ok}")
        print(f"[driver {label}] {nwin} fast dumps equal the plain "
              f"correlator's exactly", flush=True)
    check(len(cor) == nbl, f"[driver {label}] {len(cor)} COR packets of "
          f"{nbl}")
    cube = pk.cor_scatter_matrix(cor, cfg.nstand, cfg.npol)
    for k, plane in enumerate(slow):
        want = plane.reshape(cfg.nchan, cfg.nstand, cfg.npol, cfg.nstand,
                             cfg.npol).transpose(1, 3, 2, 4, 0)
        check(np.array_equal(cube[..., k], want),
              f"[driver {label}] COR slow dump vs plain")
    digests = packet_digests({"cor": cor, "subsel": sub_pkts,
                              "pbeam": pb_pkts, "ibeam": ib_pkts})
    del cube, cor
    print(f"[driver {label}] COR slow dump ({nbl} packets"
          + (" from the Python encoder" if cor_rx is None else
             f" from the C++ packetizer, max_mbps {cor_mbps}, received in "
             f"another process") + ") scatters to the plain slow dump "
          "exactly", flush=True)
    npkt = (nwin * -(-cfg.nvis_out // 16), nwin * cfg.nbeam // 2 *
            cfg.acc_len // cfg.ntime_sum, nwin * cfg.acc_len)
    check((len(sub_pkts), len(pb_pkts), len(ib_pkts)) == npkt,
          f"[driver {label}] received {len(sub_pkts)}, {len(pb_pkts)}, "
          f"{len(ib_pkts)} packets of {npkt}")
    windows, power, vlbi = decode_streams(cfg, sub_pkts, pb_pkts, ib_pkts,
                                          nwin)
    bl = np.asarray(DRIVER_BASELINES, np.uint32)
    nb = cfg.acc_len // cfg.ntime_sum
    for w, ((got_bl, sr, si), want) in enumerate(zip(windows, truth)):
        check(got_bl is not None and np.array_equal(got_bl, bl),
              f"[driver {label}] window {w}: subsel baselines")
        check(np.array_equal(sr, want["sub"][0])
              and np.array_equal(si, want["sub"][1]),
              f"[driver {label}] window {w}: subsel vs plain")
        check(np.array_equal(vlbi[w * cfg.acc_len:(w + 1) * cfg.acc_len],
                             want["vlbi"]),
              f"[driver {label}] window {w}: VLBI not exact")
        check(power_close(torch.from_numpy(power[:, w * nb:(w + 1) * nb]),
                          want["power"]),
              f"[driver {label}] window {w}: beam power vs plain")
    print(f"[driver {label}] {len(sub_pkts)} subsel, {len(pb_pkts)} PBEAM, "
          f"{len(ib_pkts)} IBEAM packets over loopback UDP: subsel and VLBI "
          f"exact, power within rtol 1e-4", flush=True)
    ends = [t0] + pipe.dump_times
    per_window = [b - a for a, b in zip(ends, ends[1:])]
    gbps = nwin * cfg.acc_len * cfg.nchan * cfg.ninput * 8 / wall / 1e9
    print(f"[{card}] driver {label}: host time per window (fast dump "
          f"products out of the output thread) "
          + ", ".join(f"{s:.3f} s" for s in per_window)
          + f"; {wall:.3f} s for {nwin} windows and the slow dump = "
          f"{gbps:.2f} Gb/s sustained (real-time bar "
          f"{cfg.input_gbps:.1f} Gb/s)", flush=True)
    return DriverRun(counts, digests, wall, per_window, gbps)


def run_driver_path(dev, card: str, blocks, gains_np) -> tuple:
    """The fourth path: the driver in both engine sets over the same
    golden windows.  Returns the launch counts summed over both runs, the
    plain products the runs were held to (for the later driver runs) and
    the ``TPU_ENGINES`` run (:class:`DriverRun`)."""
    cfg = DRIVER_CFG
    gains = bf.BeamGains(*(torch.from_numpy(x).to(dev) for x in gains_np))
    pairs = torch.from_numpy(cs.baselines_to_inputs(
        DRIVER_BASELINES).astype(np.int32)).to(dev)
    truth, slow = driver_truth(dev, cfg, blocks, gains, pairs)
    total = {name: 0 for name in KERNELS}
    switch = sys.getswitchinterval()
    # the receivers share the interpreter with the output thread
    sys.setswitchinterval(5e-4)
    try:
        for label, engines in DRIVER_ENGINES.items():
            run = run_driver(dev, card, label, engines, blocks, gains_np,
                             truth, slow)
            total = {name: total[name] + run.counts[name]
                     for name in KERNELS}
    finally:
        sys.setswitchinterval(switch)
    return total, truth, slow, run


def free_port() -> int:
    """A UDP port the operating system reports free on 127.0.0.1."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _receive_cor(conn, shm_name: str, expected: int, size: int) -> None:
    """In a process of its own: bind a loopback UDP socket with as large a
    receive buffer as the host allows, report (port, buffer bytes), read
    datagrams of up to ``size`` bytes straight into the shared memory
    ``shm_name`` with ``recvmmsg`` (``soak_wire.MMsgVec``, up to 256 a
    call; a kernel timeout of 5 s once the first has come, 120 s before)
    until ``expected`` arrived or the stream stops, and send back their
    lengths.  The bytes stay in the shared memory: a pipe carries a slow
    dump's 383 MB slowly under gVisor."""
    sock = soak_wire.bind_loopback(120.0)
    shm = shared_memory.SharedMemory(name=shm_name)
    buf = (ctypes.c_char * (expected * size)).from_buffer(shm.buf)
    try:
        msgs = soak_wire.MMsgVec(ctypes.addressof(buf), expected, size)
        conn.send((sock.getsockname()[1],
                   sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)))
        got = 0
        while got < expected:
            n = msgs.recv(sock, got, min(256, expected - got))
            if n <= 0:  # the kernel timeout: the stream has stopped
                break
            if got == 0:
                soak_wire.set_timeout(sock, 5.0)
            got += n
        sock.close()
        conn.send([msgs.length(k) for k in range(got)])
    finally:
        del buf
        shm.close()


class CorReceiver:
    """COR packets of ``size`` bytes received by another process
    (:func:`_receive_cor`) into shared memory, so that the receiver shares
    no interpreter with the pipeline."""

    def __init__(self, expected: int, size: int):
        ctx = multiprocessing.get_context("spawn")
        self.size = size
        self.shm = shared_memory.SharedMemory(create=True,
                                              size=expected * size)
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_receive_cor, daemon=True,
                                args=(child, self.shm.name, expected, size))
        self.proc.start()
        check(self.conn.poll(120), "COR receiver did not start")
        port, self.rcvbuf = self.conn.recv()
        self.addr = ("127.0.0.1", port)

    def collect(self) -> list:
        try:
            check(self.conn.poll(600), "COR receiver did not finish")
            lengths = self.conn.recv()
            self.proc.join(30)
            check(all(n == self.size for n in lengths),
                  f"COR packets of other sizes than {self.size}: "
                  f"{sorted(set(lengths))}")
            size = self.size
            raw = bytes(self.shm.buf[:len(lengths) * size])
        finally:
            self.shm.close()
            self.shm.unlink()
        return [raw[k * size:(k + 1) * size] for k in range(len(lengths))]


def cor_packet_size(cfg) -> int:
    """Bytes of one COR (Mark5C) packet: 32 of header, int32 re, im."""
    return 32 + 8 * cfg.npol * cfg.npol * cfg.nchan


class Capture:
    """A capture source (``native.CaptureSource`` or ``AdcCaptureSource``)
    on a free loopback port, fed by ``soak_wire.blast`` in a spawned
    process from ``frames`` [ngulp * ntime_gulp, nchan, ninput] uint8 in
    shared memory, gulps back to back (sequence numbers 0, ntime_gulp,
    ..., then two more that release the last), paced to ``gbps`` of
    offered payload: the blaster sleeps every 16 rows of chan-block
    packets, 16 time samples of the gulp."""

    def __init__(self, cfg, frames: np.ndarray, gbps: float,
                 adc: bool = False, nchan_per_pkt: int = 8):
        self.nbyte = frames.nbytes
        self.gbps = gbps
        self.delay_ns = int(16 * frames.shape[1] * frames.shape[2] * 8
                            / gbps)
        ngulp = frames.shape[0] // cfg.ntime_gulp
        port = free_port()
        cls = native.AdcCaptureSource if adc else native.CaptureSource
        self.source = cls(cfg, "127.0.0.1", port, nbuf=ngulp + 3, poll_s=5.0)
        self.shm = shared_memory.SharedMemory(create=True, size=frames.nbytes)
        np.ndarray(frames.shape, np.uint8, buffer=self.shm.buf)[...] = frames
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        shape = (ngulp, cfg.ntime_gulp) + frames.shape[1:]
        self.proc = ctx.Process(target=soak_wire.blast, daemon=True, args=(
            child, self.shm.name, shape, port, nchan_per_pkt,
            frames.shape[2], self.delay_ns, None, ngulp))
        self.proc.start()
        check(self.conn.poll(120) and self.conn.recv() == "ready",
              "blaster did not start")

    def go(self) -> None:
        self.conn.send("go")

    def status(self) -> str:
        """What a stalled run needs said: the capture's counters and the
        blaster's state."""
        return (f"capture counters {self.source.stats()}; blaster alive "
                f"{self.proc.is_alive()}, exit code {self.proc.exitcode}, "
                f"result waiting {self.conn.poll()}; /dev/shm "
                f"{shutil.disk_usage('/dev/shm')}")

    def finish(self, label: str) -> dict:
        """Wait for the blaster; print the pacing and the captured rate;
        fail on any packet missing from a gulp the pipeline took."""
        check(self.conn.poll(600), "blaster did not finish")
        sent, seconds = self.conn.recv()
        self.proc.join(30)
        self.shm.close()
        self.shm.unlink()
        stats = self.source.stats()
        print(f"[{label}] blaster in another process: "
              f"{sent} snap2 packets, delay_ns {self.delay_ns} every 16 "
              f"time samples ({self.gbps:.1f} Gb/s offered), sent in "
              f"{seconds:.3f} s; {stats['ngood_bytes']} payload bytes "
              f"captured = {8 * stats['ngood_bytes'] / seconds / 1e9:.2f} "
              f"Gb/s over the host's loopback; capture counters {stats}",
              flush=True)
        if stats["nmissing"]:
            raise PacketsMissing(f"[{label}] {stats['nmissing']} packets "
                                 f"missing")
        return stats


class PacketsMissing(RuntimeError):
    """A capture run that lost a packet: the run does not count."""


#: offered rates of the capture run, Gb/s; the second only after a run
#: that lost a packet
WIRE_GBPS = (4.0, 1.5)
#: gulps in the FX window sent over the wire
FX_WIRE_GULPS = 2
#: rate caps of the C++ COR packetizer tried in turn, Mb/s (-1: none)
COR_MBPS = (-1, 1500, 600)


def cor_slow_dump_alone(card: str, slow, ref: "DriverRun") -> float:
    """The driver's C++ COR sink on the slow dump alone: the plain slow
    dump through ``CorrFullOutput(native_dest=...)`` (the C++ packetizer)
    to a receiver in another process, unthrottled first; its packets byte
    for byte the Python encoder's in the golden-source driver run.  Returns
    the first rate cap at which every packet arrives.  Prints each try."""
    cfg = DRIVER_CFG
    nbl = cfg.nstand * (cfg.nstand + 1) // 2
    for mbps in COR_MBPS:
        rx = CorReceiver(nbl, cor_packet_size(cfg))
        out = sink.CorrFullOutput(cfg, native_dest=rx.addr, max_mbps=mbps,
                                  use_cor_fmt=True)
        t0 = time.perf_counter()
        n = out.send_matrix_planes(slow[0], slow[1], SYNC_TIME, 0,
                                   cfg.acc_len_slow)
        dt = time.perf_counter() - t0
        got = rx.collect()
        nbyte = sum(len(p) for p in got)
        print(f"[{card}] C++ COR packetizer (CorrFullOutput native_dest) on "
              f"the slow dump alone, max_mbps {mbps}: {n} packets sent in "
              f"{dt:.3f} s ({8 * nbyte / dt / 1e9:.2f} Gb/s of the bytes "
              f"received), {len(got)} received by another process "
              f"(receive buffer {rx.rcvbuf} B)", flush=True)
        if len(got) == nbl:
            check(packet_digests({"cor": got})["cor"] == ref.digests["cor"],
                  "[C++ COR] packets differ from the Python encoder's in "
                  "the golden-source driver run")
            print("[C++ COR] packets byte for byte the Python encoder's in "
                  "the golden-source driver run (SHA-256)", flush=True)
            return mbps
    raise RuntimeError("FAILED: COR packets lost at every rate cap")


class AdcWindowSource(ADCSource):
    """Given windows of ADC samples in ``cfg.adc_dtype``, gulp by gulp,
    for the driver's zero-copy ingest (``fill_into``)."""

    def __init__(self, cfg, windows: list):
        super().__init__(cfg)
        n = self.samples_per_gulp
        self.gulps = [w[k:k + n] for w in windows
                      for k in range(0, len(w) - n + 1, n)]

    def fill_into(self, dest):
        i = self._fill_i
        self._fill_i += 1
        dest.view(self.dtype).reshape(self.gulps[i].shape)[...] = \
            self.gulps[i]
        return i * self.cfg.ntime_gulp

    def stream(self, ngulp: int, seq0: int = 0):
        for i in range(ngulp):
            yield seq0 + i * self.cfg.ntime_gulp, self.gulps[i]


def fx_driver(cfg, src, qs: float, gains_np, **kw
              ) -> tuple[XEnginePipeline, dict]:
    """An FX ``XEnginePipeline`` on the card with every sink collecting in
    process and the integer gains commanded; returns it and its packets.
    ``kw`` goes to the pipeline."""
    CommandBlock.reset_instance_counts()
    got = {"cor": [], "subsel": [], "pbeam": [], "ibeam": []}
    store = MemoryStore()
    pipe = XEnginePipeline(
        cfg, src, store=store, sync_time=SYNC_TIME, fx_mode=True,
        quant_scale=qs,
        corr_outputs=[sink.CorrFullOutput(cfg, send=got["cor"].append,
                                          use_cor_fmt=True)],
        subsel_outputs=[sink.CorrPartOutput(cfg, send=got["subsel"].append)],
        pbeam_outputs=[sink.PBeamOutput(
            cfg, senders={b: got["pbeam"].append
                          for b in range(cfg.nbeam // 2)})],
        ibeam_outputs=[sink.IBeamOutput(cfg, send=got["ibeam"].append)],
        **{"device": "cuda", **kw})
    load_gains(pipe, store, gains_np)
    return pipe, got


def run_fx_capture(card: str, gains_np, qs: float) -> dict:
    """One int8 FX window at full width as snap2 ADC frames over loopback
    (``AdcCaptureSource``): every packet of its slow dump, subselection and
    beams equal to the same samples fed in process.  The window is cut to
    two gulps (one gulp boundary inside it) for the smoke's time limit.
    Returns its counts."""
    cfg = FX_CFG.replace(acc_len=FX_WIRE_GULPS * FX_CFG.ntime_gulp,
                         acc_len_slow=FX_WIRE_GULPS * FX_CFG.ntime_gulp)
    adc = adc_windows(cfg, 1, SEED + 5)[0]
    ngulp = cfg.acc_len // cfg.ntime_gulp
    print(f"[capture FX] depth cut to one {cfg.acc_len}-spectra window "
          f"({ngulp} gulps) of int8 ADC ({adc.nbytes} B) at the full "
          f"{cfg.ninput} inputs x {cfg.nchan} channels, for the time limit",
          flush=True)
    pipe, here = fx_driver(cfg, AdcWindowSource(cfg, [adc]), qs, gains_np)
    pipe.run(ngulp, timeout_s=600)
    frames = adc.view(np.uint8).reshape(cfg.acc_len, 2 * cfg.nchan,
                                        cfg.ninput)
    for k, gbps in enumerate(WIRE_GBPS):
        capture = Capture(cfg, frames, gbps, adc=True)
        pipe, udp = fx_driver(cfg, capture.source, qs, gains_np)
        zero_counts()
        t0 = time.perf_counter()
        capture.go()
        pipe.run(ngulp, timeout_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        try:
            capture.finish("capture FX")
        except PacketsMissing as e:
            if k + 1 == len(WIRE_GBPS):
                raise
            print(f"[capture FX] {e}; again at a lower rate", flush=True)
            continue
        finally:
            capture.source.close()
        break
    check(pipe.ndump_slow == 1 and all(here[k] == udp[k] for k in here),
          "[capture FX] packets differ from the same samples in process")
    for name in (channelizer(FX_CFG), DEFAULT_CORR, "beamform_products",
                 "subsel_gather"):
        check(counts[name] > 0, f"[capture FX] {name} not launched")
    npkt = ", ".join(f"{len(v)} {k}" for k, v in udp.items())
    print(f"[{card}] capture FX: {npkt} packets equal to the in-process "
          f"run's; {wall:.3f} s for the "
          f"window = {8 * adc.nbytes / wall / 1e9:.2f} Gb/s of ADC through "
          f"the driver; kernel launches {counts}", flush=True)
    return counts


def run_wire_path(dev, card: str, blocks, gains_np, qs: float, truth, slow,
                  ref: DriverRun) -> dict:
    """The sixth path, the wire: the driver's C++ COR sink on the slow dump
    alone, then the driver fed by the native capture from a blaster
    process (the same golden windows, its COR slow dump through the C++
    packetizer), then one FX window over ``AdcCaptureSource``.  The COR
    packets and those of the capture run equal the ``TPU_ENGINES`` driver
    run's byte for byte.  Prints the wall of each part; returns the launch
    counts."""
    cfg = DRIVER_CFG
    walls = {}
    mbps = timed(walls, "C++ COR slow dump", cor_slow_dump_alone, card,
                 slow, ref)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        t0 = time.perf_counter()
        fast = []
        for block in blocks:
            packed = torch.from_numpy(block.reshape(
                cfg.acc_len, cfg.nchan, cfg.ninput)).to(dev)
            fast.append(correlate_chan_major(chan_major(packed, "tci")))
            del packed
        frames = np.concatenate([b.reshape(cfg.acc_len, cfg.nchan,
                                           cfg.ninput) for b in blocks])
        for k, gbps in enumerate(WIRE_GBPS):
            capture = Capture(cfg, frames, gbps)
            try:
                run = run_driver(dev, card, "capture", dict(TPU_ENGINES),
                                 blocks, gains_np, truth, slow,
                                 cor_mbps=mbps, capture=capture, fast=fast)
            except PacketsMissing as e:
                if k + 1 == len(WIRE_GBPS):
                    raise
                print(f"[capture] {e}; again at a lower rate", flush=True)
                continue
            break
        del frames, fast
        walls["capture driver"] = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(switch)
    check(run.digests == ref.digests, f"[driver capture] packets differ "
          f"from the golden-source run's: {run.digests} vs {ref.digests}")
    print(f"[{card}] driver fed by the native capture: packets byte for "
          f"byte those of the golden-source run; {run.gbps:.2f} Gb/s "
          f"sustained through the driver", flush=True)
    fx = timed(walls, "FX capture", run_fx_capture, card, gains_np, qs)
    print(f"[wire] wall by part: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()), flush=True)
    return {name: run.counts[name] + fx[name] for name in KERNELS}


#: the fifth path: mesh shapes over one card, every shard on ``cuda:0``
MESH_SHAPES = ((2, 2), (1, 4))
MESH_CFG = DRIVER_CFG.replace(**TPU_ENGINES)


def gulps_of(dev, cfg, blocks):
    """The golden windows gulp by gulp on the card: (window, first gulp of
    its window, last gulp, packed [ntime_gulp, nchan, ninput])."""
    g, n = cfg.ntime_gulp, cfg.acc_len // cfg.ntime_gulp
    for w, block in enumerate(blocks):
        win = torch.from_numpy(block.reshape(cfg.acc_len, cfg.nchan,
                                             cfg.ninput)).to(dev)
        for k in range(n):
            yield w, k == 0, k == n - 1, win[k * g:(k + 1) * g]


def vis_equal(got: Vis, want: Vis) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def unshard_vis(vis) -> Vis:
    return Vis(*(pm.unshard(p) for p in vis))


def beams_match(got_p, got_v, want_p, want_v, what: str) -> bool:
    """Power and VLBI of a sharded call within the beam gate of the
    unsharded step's; returns whether both are bit-identical."""
    check(power_close(got_p, want_p), f"{what}: beam power vs unsharded")
    check(power_close(got_v, want_v), f"{what}: VLBI vs unsharded")
    return torch.equal(got_p, want_p) and torch.equal(got_v, want_v)


def mesh_xb_unsharded(dev, blocks, gains, pairs) -> tuple[list, Vis]:
    """The X/B configuration's golden windows gulp by gulp through the
    unsharded ``xengine_step``: per call the products (and the dense fast
    dump on dump calls), and the dense slow dump."""
    cfg = MESH_CFG
    state = init_state(cfg, dev)
    ref = []
    for w, first, last, gulp in gulps_of(dev, cfg, blocks):
        state, out = xengine_step(state, gulp, gains, pairs, first, last,
                                  w == 0, cfg)
        ref.append((out, dense_vis(state.vis_fast, cfg) if last else None))
    return ref, dense_vis(state.vis_slow, cfg)


def mesh_xb(dev, blocks, gains, pairs, ref: list, ref_slow: Vis) -> None:
    """The same stream through ``xengine_sharded_state_fn`` on each mesh
    shape, against the unsharded run."""
    cfg = MESH_CFG
    for shape in MESH_SHAPES:
        label = f"[mesh {shape[0]}x{shape[1]}]"
        mesh = pm.make_mesh(*shape, devices=["cuda:0"] * 4)
        before = read_counts()
        steps = {}
        state = pm.zero_sharded_state(cfg, mesh)
        same_bits = True
        for (w, first, last, gulp), (want, want_fast) in zip(
                gulps_of(dev, cfg, blocks), ref):
            key = (first, last, w == 0)
            if key not in steps:
                steps[key] = pm.xengine_sharded_state_fn(cfg, mesh, *key)
            state, out, vlbi = steps[key](state, gulp, gains, pairs)
            what = f"{label} window {w}"
            same_bits &= beams_match(pm.unshard(out.bf_power),
                                     pm.unshard(vlbi), want.bf_power,
                                     want.vlbi, what)
            check((out.vis is not None) == last, f"{what}: vis on a dump "
                  "call only")
            if last:
                check(vis_equal(unshard_vis(out.vis), want_fast),
                      f"{what}: fast dump vs unsharded")
                check(vis_equal(unshard_vis(out.subsel), want.subsel),
                      f"{what}: subsel vs unsharded")
        check(vis_equal(unshard_vis(state[1]), ref_slow),
              f"{label} slow dump vs unsharded")
        torch.cuda.synchronize()
        after = read_counts()
        made = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        check(made.get("corr_blk", 0) > 0, f"{label} corr_blk not launched")
        nshard = shape[0] * shape[1]
        per_shard = {k: v / nshard for k, v in made.items()}
        print(f"{label} {len(blocks)} windows gulp by gulp + slow dump on "
              f"{nshard} shards of cuda:0: fast, slow, subsel equal the "
              f"unsharded step's exactly; power and VLBI within rtol 1e-4, "
              f"bit-identical: {same_bits}; kernel launches {made}, per "
              f"shard {per_shard}", flush=True)


class MeshFx:
    """One FX window with a carried ADC tail through
    ``fx_sharded_state_fn`` at 2x2 against the unsharded ``fx_step``."""

    def __init__(self, dev, qs: float, gains, pairs):
        self.cfg = cfg = FX_CFG.replace(acc_len_slow=FX_CFG.acc_len,
                                        **TPU_ENGINES)
        L = 2 * cfg.nchan
        self.halo = (cfg.pfb_ntap - 1) * L
        g = torch.Generator(device=dev).manual_seed(SEED + 7)
        self.adc = torch.randint(
            -90, 91, (self.halo + cfg.acc_len * L, cfg.ninput), generator=g,
            device=dev, dtype=torch.int8)
        self.window = torch.from_numpy(pfb.pfb_window(
            cfg.nchan, cfg.pfb_ntap)).to(dev)
        self.scale = torch.tensor(qs, device=dev)
        self.dev, self.gains, self.pairs = dev, gains, pairs
        self.mesh = pm.make_mesh(2, 2, devices=["cuda:0"] * 4)

    def sharded_args(self) -> tuple:
        return (self.adc[self.halo:], self.adc[:self.halo], self.window,
                self.scale)

    def unsharded(self) -> None:
        cfg = self.cfg
        state, self.want = fx_step(
            init_state(cfg, self.dev), self.adc, self.window, self.scale,
            self.gains, self.pairs, True, True, True, cfg)
        self.want_fast = dense_vis(state.vis_fast, cfg)
        self.want_bytes = pfb.channelize_pack_imajor(
            self.adc, self.window, cfg, self.scale).permute(1, 2, 0)

    def sharded(self) -> None:
        """Packed bytes after the corner-turn, fast, slow and subsel equal
        to the unsharded step's; beam products within the gate."""
        cfg, mesh, want = self.cfg, self.mesh, self.want
        got = pm.unshard(pm.fx_packed_sharded_fn(cfg, mesh)(
            *self.sharded_args()))
        check(torch.equal(got, self.want_bytes), "[mesh FX 2x2] packed "
              "bytes after the corner-turn vs the unsharded channelizer's")
        del got
        step = pm.fx_sharded_state_fn(cfg, mesh, True, True, True)
        state, out, vlbi = step(pm.zero_sharded_state(cfg, mesh),
                                *self.sharded_args(), self.gains, self.pairs)
        same_bits = beams_match(pm.unshard(out.bf_power), pm.unshard(vlbi),
                                want.bf_power, want.vlbi, "[mesh FX 2x2]")
        check(vis_equal(unshard_vis(out.vis), self.want_fast)
              and vis_equal(unshard_vis(state[1]), self.want_fast),
              "[mesh FX 2x2] fast and slow vs unsharded")
        check(vis_equal(unshard_vis(out.subsel), want.subsel),
              "[mesh FX 2x2] subsel vs unsharded")
        torch.cuda.synchronize()
        print(f"[mesh FX 2x2] one int8 window with the carried tail: packed "
              f"bytes, fast, slow, subsel equal the unsharded fx_step's "
              f"exactly; power and VLBI within rtol 1e-4, bit-identical: "
              f"{same_bits}", flush=True)
        del self.want, self.want_fast, self.want_bytes

    def times(self, card: str) -> None:
        cfg = self.cfg
        state = init_state(cfg, self.dev)
        fx_ms = cuda_ms(lambda: fx_step(
            state, self.adc, self.window, self.scale, self.gains, self.pairs,
            True, True, False, cfg), 5)
        del state
        state = pm.zero_sharded_state(cfg, self.mesh)
        step = pm.fx_sharded_state_fn(cfg, self.mesh, True, True, False)
        mesh_ms = cuda_ms(lambda: step(state, *self.sharded_args(),
                                       self.gains, self.pairs), 5)
        print(f"[{card}] FX window, device time: fx_sharded_state_fn 2x2 on "
              f"one card {mesh_ms:.3f} ms, unsharded fx_step {fx_ms:.3f} ms",
              flush=True)


def mesh_times(dev, card: str, gains, pairs) -> dict:
    """Device time per whole-window call of the sharded X/B step on one
    card beside the unsharded step with the same engines."""
    cfg = MESH_CFG
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    packed = torch.randint(0, 256, (cfg.acc_len, cfg.nchan, cfg.ninput),
                           generator=g, device=dev, dtype=torch.uint8)
    state = init_state(cfg, dev)
    ms = {"unsharded": cuda_ms(lambda: xengine_step(
        state, packed, gains, pairs, True, True, False, cfg), 5)}
    del state
    for shape in MESH_SHAPES:
        mesh = pm.make_mesh(*shape, devices=["cuda:0"] * 4)
        state = pm.zero_sharded_state(cfg, mesh)
        step = pm.xengine_sharded_state_fn(cfg, mesh, True, True, False)
        ms[f"{shape[0]}x{shape[1]}"] = cuda_ms(
            lambda: step(state, packed, gains, pairs), 5)
        del state, step
    print(f"[{card}] X/B window (dump call, one 2400-spectra block), device "
          f"time: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()),
          flush=True)
    return ms


def run_mesh_path(dev, card: str, blocks, gains_np, qs: float, truth, slow,
                  driver_ref: DriverRun) -> tuple[dict, dict]:
    """The fifth path: the sharded programs of ``parallel/mesh.py`` at
    full width with every shard on this card, and the driver over a 2x2
    mesh with every sink.  Returns the path's launch counts and the
    device ms of a dump call by mesh shape."""
    gains = bf.BeamGains(*(torch.from_numpy(x).to(dev) for x in gains_np))
    pairs = torch.from_numpy(PAIRS).to(dev)
    # the unsharded runs come first: their launches are not the path's
    ref, ref_slow = mesh_xb_unsharded(dev, blocks, gains, pairs)
    fx = MeshFx(dev, qs, gains, pairs)
    fx.unsharded()
    zero_counts()
    mesh_xb(dev, blocks, gains, pairs, ref, ref_slow)
    del ref, ref_slow
    fx.sharded()
    programs = read_counts()
    for name in ("corr_blk", channelizer(FX_CFG), "beamform_products",
                 "subsel_gather"):
        check(programs[name] > 0, f"[mesh] {name} not launched by the "
              "sharded programs")
    check(programs["corr_acc"] == 0 and programs["corr_acc_cached"] == 0,
          "[mesh] the sharded programs launched the unsharded correlator")
    print(f"[mesh] kernel launches of the sharded programs: {programs}",
          flush=True)
    fx.times(card)
    del fx
    mesh_ms = mesh_times(dev, card, gains, pairs)
    vols = pm.collective_volumes(LWA352, 2, 2)
    print("collective_volumes(LWA352, 2, 2): " + json.dumps(vols),
          flush=True)
    check(vols["mesh"]["devices"] == 4 and len(vols["collectives"]) == 4,
          "collective_volumes")

    mesh = pm.make_mesh(2, 2, devices=["cuda:0"] * 4)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        run = run_driver(dev, card, "mesh 2x2", dict(TPU_ENGINES), blocks,
                         gains_np, truth, slow, mesh=mesh)
    finally:
        sys.setswitchinterval(switch)
    check(run.digests == driver_ref.digests, f"[driver mesh 2x2] packets "
          f"differ from the unsharded driver run's: {run.digests} vs "
          f"{driver_ref.digests}")
    print(f"[driver mesh 2x2] COR, subsel, PBEAM and IBEAM packets byte for "
          f"byte those of the unsharded TPU_ENGINES run ({run.wall:.3f} s "
          f"against {driver_ref.wall:.3f} s wall)", flush=True)
    return ({name: programs[name] + run.counts[name] for name in KERNELS},
            mesh_ms)


def run_schedules_path(dev, cfg, blocks, slow) -> dict:
    """The two correlator schedules that no engine name selects, each over
    the golden stream through its wrapper: ``corr_acc`` with the
    ``unpack_cache`` that is not the default carries the fast and slow
    accumulators gulp by gulp over the three windows, ``corr_rows``
    correlates each gulp and the results are summed.  Both slow sums must
    equal the plain slow dump.  Returns the counts."""
    zero_counts()
    state = init_state(cfg, dev)
    total = None
    other = not UNPACK_CACHE_DEFAULT
    other_name = "corr_acc_cached" if other else "corr_acc"
    for w, first, last, gulp in gulps_of(dev, cfg, blocks):
        corr_acc(gulp, *state, first, last, w == 0, unpack_cache=other)
        vis = crows.corr_rows(gulp)
        if total is None:
            total = vis
        else:
            for a, b in zip(total, vis):
                a.add_(b)
    torch.cuda.synchronize()
    counts = read_counts()
    want = Vis(*(torch.from_numpy(p).to(dev) for p in slow))
    check(vis_equal(dense_vis(state.vis_slow, cfg), want),
          f"corr_acc(unpack_cache={other}) slow dump over the golden stream")
    check(vis_equal(dense_vis(total, cfg), want),
          "corr_rows summed over the golden stream")
    for name in (other_name, "corr_rows"):
        check(counts[name] > 0, f"{name} not launched")
    print(f"correlator schedules over the golden stream: slow dumps of "
          f"corr_acc(unpack_cache={other}) and of summed corr_rows gulps "
          f"equal the plain slow dump exactly; kernel launches {counts}",
          flush=True)
    return counts


#: the seventh path: the transient recorder and the control plane
RECORD_CFG = DRIVER_CFG.replace(**TPU_ENGINES)
#: the history ring of the in-process runs: 10 X/B frames (649 MB at full
#: width); two files of one window each
RECORD_NFRAME = 10
#: the CLI run: slow dumps of 4 windows against a golden file of one gulp,
#: a 0.7 GB history ring (10 frames at full width)
CLI_ACC_LEN_SLOW = 9600
CLI_BUFGBYTES = 0.7


def record_dir() -> Path:
    """A directory for dump files beside this script (on the checkout's
    filesystem, where O_DIRECT may be accepted), removed after the path."""
    return Path(tempfile.mkdtemp(prefix="_record_",
                                 dir=Path(__file__).resolve().parent))


class PushClock:
    """Wraps a pipeline's ``history.push``: the start and length of every
    push, and the spans in which a dump's ``trigger`` ran."""

    def __init__(self, pipe):
        self.starts, self.lengths, self.dumps = [], [], []
        push, trigger = pipe.history.push, pipe.dumper.trigger

        def timed_push(frame):
            t0 = time.perf_counter()
            push(frame)
            self.starts.append(t0)
            self.lengths.append(time.perf_counter() - t0)

        def timed_trigger(*a, **k):
            t0 = time.perf_counter()
            try:
                return trigger(*a, **k)
            finally:
                self.dumps.append((t0, time.perf_counter()))

        pipe.history.push = timed_push
        pipe.dumper.trigger = timed_trigger

    def push_ms(self) -> float:
        return 1e3 * float(np.median(self.lengths))

    def gap_during_dump_ms(self):
        """The longest gap between two push starts that overlaps a dump,
        or None where no push fell into one."""
        gaps = [(b - a) for a, b in zip(self.starts, self.starts[1:])
                if any(a < e and b > s for s, e in self.dumps)]
        return 1e3 * max(gaps) if gaps else None


def dump_files_match(files, gulp_at, ntime_gulp: int, what: str) -> None:
    """Every file's bytes are the gulps fed in (``gulp_at(i)``, gulp i of
    the stream) from its header's seq0 on."""
    check(len(files) > 0, f"{what}: no dump files")
    for f in files:
        hdr, data = TriggerFileSource(str(f)).read()
        g0, n = hdr["seq0"] // ntime_gulp, hdr["ntime"] // ntime_gulp
        check(hdr["seq0"] % ntime_gulp == 0 and n >= 1
              and n * ntime_gulp == hdr["ntime"],
              f"{what}: {Path(f).name} header {hdr['seq0']}, "
              f"{hdr['ntime']}")
        for k in range(n):
            check(np.array_equal(
                data[k * ntime_gulp:(k + 1) * ntime_gulp], gulp_at(g0 + k)),
                f"{what}: {Path(f).name} gulp {k} differs from the input")


def timed_writes(dumper) -> list:
    """Wraps ``dumper._write_file``: (bytes, seconds) of every file."""
    out = []
    write = dumper._write_file

    def timed(fname, header, data):
        t0 = time.perf_counter()
        write(fname, header, data)
        out.append((data.nbytes, time.perf_counter() - t0))

    dumper._write_file = timed
    return out


def mb_s(writes: list) -> float:
    return sum(n for n, _ in writes) / sum(s for _, s in writes) / 1e6


def wait_idle(block, before=None, timeout_s: float = 120.0) -> list:
    """Wait for a dump thread's end: ``state`` idle with other
    ``last_files`` than ``before`` (the previous dump's); its files."""
    deadline = time.monotonic() + timeout_s
    while (block.stats.get("state") != "idle"
           or block.stats.get("last_files") == before):
        check(time.monotonic() < deadline, "dump thread did not end")
        time.sleep(0.02)
    return block.stats["last_files"]


def recorder_driver(dev, cfg, blocks, store, history: bool, sub: list):
    """The driver over the golden windows with a subselection sink
    collecting in process, optionally with the history ring."""
    CommandBlock.reset_instance_counts()
    pipe = XEnginePipeline(
        cfg, GoldenSource(cfg, blocks), store=store, sync_time=SYNC_TIME,
        subsel_outputs=[sink.CorrPartOutput(cfg, send=sub.append)],
        history_nbyte=RECORD_NFRAME * cfg.gulp_nbyte if history else 0,
        device=dev.type)
    command(store, pipe.subsel_cmd.command_key, "bl",
            baselines=DRIVER_BASELINES)
    return pipe


def subsel_matches(cfg, sub: list, truth: list, what: str) -> None:
    windows, _, _ = decode_streams(cfg, sub, [], [], len(truth))
    for w, ((bl, sr, si), want) in enumerate(zip(windows, truth)):
        check(bl is not None and np.array_equal(sr, want["sub"][0])
              and np.array_equal(si, want["sub"][1]),
              f"{what}: window {w} subselection vs plain")


def replay_xb(dev, cfg, files, gains_np, truth, fast_plain) -> None:
    """Each file through the served driver on the card, its frames from
    the file's ``seq0`` with both integrators armed there: the fast dump
    equal to the plain correlator's for its window, subselection and VLBI
    exact, power within rtol 1e-4."""
    pairs = torch.from_numpy(cs.baselines_to_inputs(
        DRIVER_BASELINES).astype(np.int32)).to(dev)
    for f in files:
        hdr, data = TriggerFileSource(str(f)).read()
        seq0 = hdr["seq0"]
        w = seq0 // cfg.acc_len
        _, kept, fast = kept_driver(
            cfg, GoldenSource(cfg, [data], seq0=seq0), gains_np, pairs,
            len(data) // cfg.ntime_gulp, autostartat=seq0)
        check(list(kept.vlbi) == [seq0] and len(fast) == 1,
              f"replay of {Path(f).name}: step calls at {list(kept.vlbi)}, "
              f"{len(fast)} fast dumps")
        check(vis_equal(fast[0], fast_plain[w]),
              f"replay of window {w}: fast dump vs plain")
        want = truth[w]
        check(np.array_equal(kept.subsel[seq0][0], want["sub"][0])
              and np.array_equal(kept.subsel[seq0][1], want["sub"][1]),
              f"replay of window {w}: subsel vs plain")
        check(np.array_equal(kept.vlbi[seq0], want["vlbi"]),
              f"replay of window {w}: VLBI not exact")
        check(power_close(torch.from_numpy(kept.power[seq0]), want["power"]),
              f"replay of window {w}: beam power vs plain")
        print(f"[record] replay of {Path(f).name} (window {w}) through the "
              "driver: fast dump, subsel and VLBI exact, power within rtol "
              "1e-4", flush=True)


def run_recorder_xb(dev, card: str, blocks, gains_np, truth, tmp: Path
                    ) -> None:
    """The X/B recorder in process: the driver without and with a history
    ring of 10 frames on a ``kv://`` store, a trigger through the client
    while the ring fills and one after the run, the files held to the
    golden gulps and replayed, the same frames written with O_DIRECT."""
    cfg = RECORD_CFG
    nwin = len(blocks)
    ngulp = nwin * cfg.acc_len // cfg.ntime_gulp
    gulps = GoldenSource(cfg, blocks).gulps
    bits = ngulp * cfg.gulp_nbyte * 8
    fast_plain = []
    for block in blocks:
        packed = torch.from_numpy(block.reshape(cfg.acc_len, cfg.nchan,
                                                cfg.ninput)).to(dev)
        fast_plain.append(correlate_chan_major(chan_major(packed, "tci")))
        del packed
    sub = []
    pipe = recorder_driver(dev, cfg, blocks, MemoryStore(), False, sub)
    t0 = time.perf_counter()
    pipe.run(ngulp, timeout_s=600)
    plain_gbps = bits / (time.perf_counter() - t0) / 1e9
    subsel_matches(cfg, sub, truth, "[record] driver without the ring")

    server = StoreServer("127.0.0.1", 0)
    kv = f"kv://127.0.0.1:{server.port}"
    try:
        store = connect(kv)
        sub = []
        pipe = recorder_driver(dev, cfg, blocks, store, True, sub)
        clock = PushClock(pipe)
        control = PipelineControl(CorrControlClient(store=store,
                                                    timeout_s=30.0),
                                  socket.gethostname(), 0)
        live = tmp / "live"
        live.mkdir()

        def trigger_while_filling():
            while pipe.history.count < 3 and not pipe._stop.is_set():
                time.sleep(0.001)
            control.triggered_dump.trigger(ntime_per_file=cfg.acc_len,
                                           nfile=2, dump_path=str(live))

        th = threading.Thread(target=trigger_while_filling, daemon=True)
        th.start()
        t0 = time.perf_counter()
        pipe.run(ngulp, timeout_s=600)
        ring_gbps = bits / (time.perf_counter() - t0) / 1e9
        th.join(60)
        subsel_matches(cfg, sub, truth, "[record] driver with the ring")
        first = wait_idle(pipe.dump_cmd)
        dump_files_match(first, gulps.__getitem__, cfg.ntime_gulp,
                         "[record] dump while the ring filled")
        gap = clock.gap_during_dump_ms()
        shutil.rmtree(live)

        # after the run: the ring holds windows 1 and 2
        writes = timed_writes(pipe.dumper)
        after = tmp / "after"
        after.mkdir()
        resp = control.triggered_dump.trigger(
            ntime_per_file=cfg.acc_len, nfile=2, dump_path=str(after))
        check(resp["status"] == "normal", f"trigger: {resp}")
        files = wait_idle(pipe.dump_cmd, first)
        check(len(files) == 2 and [TriggerFileSource(f).header["seq0"]
                                   for f in files]
              == [cfg.acc_len, 2 * cfg.acc_len],
              f"[record] files after the run: {files}")
        dump_files_match(files, gulps.__getitem__, cfg.ntime_gulp,
                         "[record] dump after the run")
        print(f"[record] {len(files)} files of the trigger after the run "
              "hold the golden gulps of windows 1 and 2 byte for byte",
              flush=True)
        replay_xb(dev, cfg, files, gains_np, truth, fast_plain)
        direct = sink.TriggeredDump(pipe.history, dump_path=str(tmp),
                                    file_prefix="direct", direct=True)
        dwrites = timed_writes(direct)
        dfiles = direct.trigger(cfg.acc_len, nfile=2)
        for a, b in zip(files, dfiles):
            check(filecmp.cmp(a, b, shallow=False),
                  f"[record] {Path(b).name} differs from the buffered file")
        accepted = direct.last_direct
        shutil.rmtree(after)
        for f in dfiles:
            os.remove(f)
        rtt = []
        for _ in range(20):
            t0 = time.perf_counter()
            control.corr.set_acc_length(cfg.acc_len)
            rtt.append(time.perf_counter() - t0)
        store.close()
    finally:
        server.close()
    print(f"[{card}] HistoryRing.push of an X/B frame "
          f"({cfg.gulp_nbyte / 1e6:.1f} MB): {clock.push_ms():.3f} ms "
          f"(median of {len(clock.lengths)})", flush=True)
    print(f"[{card}] driver over {nwin} windows with a subselection sink: "
          f"{plain_gbps:.3f} Gb/s without the history ring, {ring_gbps:.3f} "
          f"Gb/s with it ({RECORD_NFRAME} frames, "
          f"{RECORD_NFRAME * cfg.gulp_nbyte / 1e6:.0f} MB)", flush=True)
    print(f"[{card}] longest gap between two ingest pushes while a dump "
          f"ran: " + ("no push fell into a dump" if gap is None
                      else f"{gap:.3f} ms")
          + f" (median gap {1e3 * float(np.median(np.diff(clock.starts))):.3f}"
          " ms)", flush=True)
    print(f"[{card}] dump of {sum(n for n, _ in writes) / 1e6:.0f} MB: "
          f"{mb_s(writes):.1f} MB/s buffered, {mb_s(dwrites):.1f} MB/s with "
          f"dump_direct; O_DIRECT {'accepted' if accepted else 'refused'} by "
          f"the dump directory's filesystem (the direct run was written "
          f"{'with O_DIRECT' if accepted else 'buffered'})", flush=True)
    print(f"[{card}] kv:// command round trip (CorrControl.set_acc_length "
          f"through a StoreServer in process): "
          f"{1e3 * float(np.median(rtt)):.3f} ms median of {len(rtt)}",
          flush=True)


def run_recorder_fx(dev, card: str, gains_np, qs: float, tmp: Path) -> None:
    """One int8 FX window at full width with the ADC history ring (5
    frames): the dump, triggered through the client, equals the ADC fed
    in, and its replay through the FX driver gives the live run's packed
    bytes and fast dump exactly (the dump starts at the stream's first
    frame, where the live FIR history was zero, as the replay's)."""
    cfg = FX_CFG.replace(acc_len_slow=FX_CFG.acc_len)
    adc = adc_windows(cfg, 1, SEED + 7)[0]
    ngulp = cfg.acc_len // cfg.ntime_gulp
    frame_nbyte = adc.nbytes // ngulp
    packed = {}
    channelize = pfb.channelize_pack_imajor

    def keep(label):
        def wrapped(*a, **k):
            out = channelize(*a, **k)
            packed[label] = out.clone()
            return out
        return wrapped

    live_fast = []
    pfb.channelize_pack_imajor = keep("live")
    try:
        pipe, _ = fx_driver(cfg, AdcWindowSource(cfg, [adc]), qs, gains_np,
                            history_nbyte=ngulp * frame_nbyte,
                            device=dev.type)
        check(pipe.history.nframe == ngulp, "[record FX] ring frames")
        clock = PushClock(pipe)
        emit = pipe._emit

        def keep_fast(out, t, dec, slow_dec):
            emit(out, t, dec, slow_dec)
            live_fast.append(Vis(*(p.clone() for p in pipe._dense("fast"))))

        pipe._emit = keep_fast
        pipe.run(ngulp, timeout_s=600)
        control = PipelineControl(CorrControlClient(store=pipe.dump_cmd.store,
                                                    timeout_s=30.0),
                                  socket.gethostname(), 0)
        control.triggered_dump.trigger(ntime_per_file=adc.shape[0], nfile=1,
                                       dump_path=str(tmp))
        files = wait_idle(pipe.dump_cmd)
        check(len(files) == 1, f"[record FX] files: {files}")
        hdr, data = TriggerFileSource(files[0]).read()
        check(hdr["adc"] and hdr["nbit"] == 8 and hdr["seq0"] == 0
              and np.array_equal(data, adc),
              "[record FX] dumped ADC differs from the ADC fed in")
        pfb.channelize_pack_imajor = keep("replay")
        _, kept, replay_fast = kept_driver(
            cfg, AdcWindowSource(cfg, [data]), gains_np, None, ngulp,
            fx_mode=True, quant_scale=qs)
    finally:
        pfb.channelize_pack_imajor = channelize
    check(list(kept.vlbi) == [0] and len(replay_fast) == 1
          and len(live_fast) == 1,
          f"[record FX] replay calls at {list(kept.vlbi)}, "
          f"{len(replay_fast)} replay and {len(live_fast)} live dumps")
    check(torch.equal(packed["replay"], packed["live"]),
          "[record FX] replayed packed bytes differ from the live run's")
    check(vis_equal(replay_fast[0], live_fast[0]),
          "[record FX] replayed fast dump differs from the live run's")
    os.remove(files[0])
    print(f"[record FX] the dump ({data.nbytes} B of int8 ADC) equals the "
          "ADC fed in; its replay through the FX driver gives the live "
          "run's packed bytes and fast dump exactly", flush=True)
    print(f"[{card}] HistoryRing.push of an FX frame "
          f"({frame_nbyte / 1e6:.1f} MB of int8 ADC): {clock.push_ms():.3f} "
          f"ms (median of {len(clock.lengths)})", flush=True)


def golden_gulp_files(dev, cfg, tmp: Path, nrep: int) -> tuple:
    """Golden vectors of one gulp at full width: ``in.dat``, the first
    ``ntime_gulp`` spectra of the reference's RNG stream, and ``corr.dat``,
    their correlation ``nrep`` times over (an integration of ``nrep``
    gulps of the looped file) computed by the plain correlator on the card
    and anchored to the host truth on 4 channels.  Returns the paths and
    the gulp."""
    g = cfg.ntime_gulp
    din = tmp / "in.dat"
    golden.write_input_file(str(din), g, cfg.nchan, cfg.nstand, cfg.npol, g)
    _, gulp = golden.read_dat(str(din))
    gulp = gulp.reshape(g, cfg.nchan, cfg.ninput).copy()  # writable
    packed = torch.from_numpy(gulp).to(dev)
    vis = correlate_chan_major(chan_major(packed, "tci"))
    hvr, hvi = golden.host_corr_int32(
        gulp[:, :4].reshape(g, 4, cfg.nstand, cfg.npol))
    check(np.array_equal(vis.real[:4].cpu().numpy(), hvr)
          and np.array_equal(vis.imag[:4].cpu().numpy(), hvi),
          "golden gulp: plain correlator vs host on 4 channels")
    dcorr = tmp / "corr.dat"
    write_corr_dat(str(dcorr), vis, cfg, nrep * g)
    return din, dcorr, gulp


def write_corr_dat(path: str, vis: Vis, cfg, acc_len: int) -> None:
    """One integration of a golden correlation file: dense int32 planes
    [nchan, ninput, ninput] times ``acc_len // ntime_gulp`` as complex128
    [1, nchan, nstand, nstand, npol, npol] (``golden.write_corr_file``'s
    layout)."""
    nrep = acc_len // cfg.ntime_gulp
    ns, npol = cfg.nstand, cfg.npol
    meta = {"time": 0.0, "acc_len": acc_len, "ntime": 1, "nstand": ns,
            "npol": npol, "nchan": cfg.nchan, "seed": golden.DEFAULT_SEED,
            "shape": [1, cfg.nchan, ns, ns, npol, npol],
            "dtype": "np.complex", "type": "random"}
    with open(path, "wb") as fh:
        fh.write(json.dumps(meta).encode() + b"\n")
        for c in range(cfg.nchan):
            z = torch.complex(vis.real[c].double(), vis.imag[c].double())
            z = (z * nrep).reshape(ns, npol, ns, npol).permute(0, 2, 1, 3)
            fh.write(z.contiguous().cpu().numpy().tobytes())


def manager_rpc(store, host: str, cmd: str, seq: str, wait_s: float = 60.0,
                **kwargs) -> dict:
    """One RPC to the host manager; the response's ``val``."""
    key, resp_key = (f"/cmd/corr/x/{host}/xctrl",
                     f"/resp/corr/x/{host}/xctrl")
    store.put(key, json.dumps({"cmd": cmd, "id": seq,
                               "val": {"kwargs": kwargs}}))
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        raw = store.get(resp_key)
        if raw and json.loads(raw).get("id") == seq:
            return json.loads(raw)["val"]
        time.sleep(0.05)
    raise RuntimeError(f"manager did not answer {cmd}")


def poll(fn, what: str, timeout_s: float, poll_s: float = 0.2):
    """``fn()`` until it returns something true, for at most
    ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(poll_s)
    raise RuntimeError(f"timed out: {what}")


def run_manager_cli(dev, card: str, tmp: Path, cfg=LWA352) -> None:
    """``xeng_manager --serve-kv`` as a subprocess; its controller starts
    the port's CLI on the golden vectors at full width with ``--etcdhost
    kv://``, ``--bufgbytes 0.7`` and ``--dump-direct``; the client arms it
    (``arm_and_wait`` with ``acc_len``), triggers a dump, and the manager
    stops it: exit code 0 with every slow dump equal to the golden file."""
    din, dcorr, gulp = golden_gulp_files(dev, cfg, tmp,
                                         CLI_ACC_LEN_SLOW // cfg.ntime_gulp)
    port = free_tcp_port()
    kv = f"kv://127.0.0.1:{port}"
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    log_path = tmp / "manager.log"
    log = open(log_path, "wb")
    t_start = time.perf_counter()
    mgr = subprocess.Popen(
        [sys.executable, "-m",
         "caltech_bifrost_dsp_tpu_torch.scripts.xeng_manager",
         "--serve-kv", str(port), "--pidfile-dir", str(tmp)],
        cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    store = None
    try:
        def connected():
            try:
                return connect(kv)
            except OSError:
                return None

        store = poll(connected, "the manager's kv:// store", 60)
        host = socket.gethostname()
        args = ["--fakesource", "--testdatain", str(din), "--testdatacorr",
                str(dcorr), "--testdatacorr_acc_len", str(CLI_ACC_LEN_SLOW),
                "--nstand", str(cfg.nstand), "--nchan", str(cfg.nchan),
                "--nbeam", str(cfg.nbeam), "--ntime_gulp",
                str(cfg.ntime_gulp), "--acc_len", str(cfg.acc_len),
                "--acc_len_slow", str(CLI_ACC_LEN_SLOW), "--etcdhost", kv,
                "--bufgbytes", str(CLI_BUFGBYTES), "--dump-direct",
                "--device", dev.type]
        r = manager_rpc(store, host, "start_pipeline", "start",
                        pipeline_id=0, extra_args=args)
        check(r["status"] == "normal" and r["response"]["ok"],
              f"start_pipeline: {r}")
        client = CorrControlClient(store=store, timeout_s=60.0)
        pl = PipelineControl(client, host, 0)

        def corr_stats():
            return pl.corr.get_status().get("stats", {})

        poll(lambda: corr_stats().get("state") == "running",
             "the CLI pipeline running", 180)
        t_up = time.perf_counter() - t_start
        # two slow dumps before the arm: an arm that skips a slow boundary
        # leaves the slow accumulator off its grid (ROADMAP queue 3)
        poll(lambda: corr_stats()["curr_sample"] >= 2 * CLI_ACC_LEN_SLOW,
             "two slow dumps", 300)
        # a host-bound driver runs the stream slower than real time, so the
        # start is taken from the stream's position, not the wall clock
        s0, t0 = corr_stats()["curr_sample"], time.time()
        s1 = poll(lambda: (corr_stats()["curr_sample"] > s0
                           and corr_stats()["curr_sample"]), "progress", 60)
        rate = (s1 - s0) / (time.time() - t0)
        status = pl.corr.get_status()
        ahead = max(5 * cfg.acc_len, int(rate * 10))
        delay = ((s1 + ahead) / cfg.spectra_rate_hz
                 - (time.time() - status["sync_time"]))
        t0 = time.perf_counter()
        start = CorrelatorControl(client, [pl]).arm_and_wait(
            delay_s=delay, acc_len=cfg.acc_len, timeout_s=180.0)
        t_arm = time.perf_counter() - t0
        rtt = []
        for _ in range(5):
            t0 = time.perf_counter()
            pl.corr.set_acc_length(cfg.acc_len)
            rtt.append(time.perf_counter() - t0)
        dumps = tmp / "cli_dumps"
        dumps.mkdir()
        r = pl.triggered_dump.trigger(ntime_per_file=cfg.acc_len, nfile=1,
                                      dump_path=str(dumps))
        check(r["status"] == "normal", f"trigger: {r}")
        st = poll(lambda: (lambda s: s.get("state") == "idle"
                           and s.get("last_files") and s)(
            pl.triggered_dump.get_status().get("stats", {})),
            "the CLI pipeline's dump", 120)
        files = st["last_files"]
        dump_files_match(files, lambda i: gulp, cfg.ntime_gulp,
                         "[record CLI] dump of the CLI pipeline")
        direct = st.get("last_direct")
        for f in files:
            os.remove(f)
        r = manager_rpc(store, host, "stop_pipeline", "stop", wait_s=240,
                        pipeline_id=0, timeout_s=180.0)
        check(r["status"] == "normal" and r["response"].get("returncode")
              == 0, f"stop_pipeline: {r}")
    finally:
        if store is not None:
            store.close()
        mgr.send_signal(signal.SIGTERM)
        try:
            mgr.wait(60)
        except subprocess.TimeoutExpired:
            mgr.kill()
            mgr.wait()
        log.close()
    text = log_path.read_text(errors="replace")
    m = re.findall(r"golden check: (\d+)/(\d+) passed", text)
    check(mgr.returncode == 0 and m and int(m[-1][1]) >= 1
          and m[-1][0] == m[-1][1],
          f"[record CLI] manager rc {mgr.returncode}, golden {m}; log tail:"
          f"\n{text[-3000:]}")
    print(f"[record CLI] xeng_manager --serve-kv started the port's CLI at "
          f"{cfg.nstand} stands x {cfg.nchan} channels ({t_up:.1f} s to "
          f"'running'); arm_and_wait armed it at spectra {start} "
          f"({t_arm:.1f} s, stream at {rate:.0f} spectra/s); the dump of "
          f"{len(files)} file equals the golden gulps (O_DIRECT "
          f"{'accepted' if direct else 'refused'}); stopped with exit code 0,"
          f" golden check {m[-1][0]}/{m[-1][1]} slow dumps", flush=True)
    print(f"[{card}] kv:// command round trip to the CLI pipeline in another "
          f"process: {1e3 * float(np.median(rtt)):.3f} ms median of "
          f"{len(rtt)}", flush=True)


def free_tcp_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_etcd_wire() -> None:
    """One command round trip over the etcd v3 wire protocol: the port's
    Etcd3Client against an Etcd3Server in process.  Does not run without
    ``grpc``, and says so."""
    try:
        import grpc  # noqa: F401
    except ImportError:
        print("[record] etcd3 wire: this phase did not run because grpc is "
              "not installed on this host", flush=True)
        return
    server = Etcd3Server("127.0.0.1", 0)
    store = connect("127.0.0.1", server.port)
    try:
        CommandBlock.reset_instance_counts()
        blk = CommandBlock("Corr", store=store, host="etcdhost")
        blk.define_command_key("acc_len", type=int, initial_val=2400)
        client = CorrControlClient(store=store, timeout_s=30.0)
        t0 = time.perf_counter()
        r = client.send_command("etcdhost", 0, "Corr", blk.instance_id,
                                acc_len=4800)
        ms = 1e3 * (time.perf_counter() - t0)
        blk.update_command_vals()
        check(r["status"] == "normal" and blk.command_vals["acc_len"] == 4800,
              f"etcd3 wire round trip: {r}")
        blk.close()
    finally:
        store.close()
        server.stop()
    print(f"[record] etcd3 wire: a command round trip through Etcd3Client "
          f"and Etcd3Server in {ms:.3f} ms", flush=True)


def run_record_path(dev, card: str, blocks, gains_np, qs: float, truth
                    ) -> dict:
    """The seventh path, control and record: the transient recorder in
    process (X/B and FX), the CLI under the host manager, the etcd3 wire.
    Returns the launch counts."""
    tmp = record_dir()
    try:
        zero_counts()
        run_recorder_xb(dev, card, blocks, gains_np, truth, tmp)
        run_recorder_fx(dev, card, gains_np, qs, tmp)
        counts = read_counts()
        run_manager_cli(dev, card, tmp)
        run_etcd_wire()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in (DEFAULT_CORR, "beamform_products", "subsel_gather",
                 channelizer(FX_CFG)):
        check(counts[name] > 0, f"[record] {name} not launched")
    print(f"[record] kernel launches: {counts}", flush=True)
    return counts


#: the eighth path: one golden window dumped at full width (2400 spectra,
#: 324 MB) and replayed by the offline CLIs
OFFLINE_RA = "0.0,90.0,180.0,270.0"
OFFLINE_DEC = "37.2398,20.0,60.0,-10.0"
OFFLINE_GULP = 480
#: fine channels of the imaging gate: both ends of the band and both sides
#: of nine coarse channels' seams (coarse c holds fine 2c, 2c + 1 at nup 2)
IMAG_CHANNELS = (0, 1, 2, 47, 48, 95, 96, 191, 192, 239, 240, 287, 288, 335,
                 336, 381, 382, 383)
#: the COR stream's pace for a Python ``recv`` loop in another process.
#: Its 8 MB receive buffer (the most the card's host grants) rides out a
#: stall of the receiver of 0.67 s at 100 Mb/s, 0.27 s at 250 Mb/s, where
#: runs of this phase and of ``scripts/probe_rx.py`` lost packets
#: (PERF.md section 6)
RX_COR_MBPS = 100


def offline_dump(tmp: Path, block: np.ndarray) -> str:
    """One golden window through a ``HistoryRing`` of 5 gulp frames and
    the port's ``TriggeredDump``; the file's path."""
    cfg = LWA352
    ring = HistoryRing(nbyte=5 * cfg.gulp_nbyte, frame_nbyte=cfg.gulp_nbyte)
    ring.set_header(sequence_header(cfg, seq0=0, sync_time=SYNC_TIME),
                    frame0_seq=0)
    frames = block.reshape(-1, cfg.ntime_gulp * cfg.nchan * cfg.ninput)
    for frame in frames:
        ring.push(frame)
    t0 = time.perf_counter()
    files = sink.TriggeredDump(ring, dump_path=str(tmp)).trigger(
        ntime_per_file=cfg.acc_len)
    dt = time.perf_counter() - t0
    check(len(files) == 1, f"[offline] dump wrote {files}")
    h, data = TriggerFileSource(files[0]).read()
    check(h["ntime"] == cfg.acc_len and np.array_equal(
        data, block.reshape(data.shape)), "[offline] dump != golden window")
    print(f"[offline] dump of {data.nbytes / 1e6:.1f} MB "
          f"({cfg.acc_len} spectra x {cfg.nchan} channels x {cfg.ninput} "
          f"inputs) written in {dt:.3f} s", flush=True)
    return files[0]


def have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def run_cli(cli, argv: list, hdf5: bool, walls: dict, label: str):
    """One offline CLI on the card: ``main`` where ``h5py`` imports (its
    writer timed), else the same replay without the writers.  Puts the
    wall seconds (and the writer's MB/s) into ``walls``; returns the
    replay, or None where ``main`` ran."""
    t0 = time.perf_counter()
    if hdf5:
        write, spans = cli.write, []

        def timed(args, replay):
            t = time.perf_counter()
            write(args, replay)
            spans.append(time.perf_counter() - t)

        cli.write = timed
        try:
            check(cli.main(argv) == 0, f"[offline] {cli.__name__} exit code")
        finally:
            cli.write = write
        replay = None
    else:
        replay = cli.Replay(cli.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    walls[label] = time.perf_counter() - t0
    if hdf5:
        out = Path(argv[argv.index("--output") + 1])
        walls[label + " HDF5 MB/s"] = out.stat().st_size / spans[0] / 1e6
    return replay


def beam_truth(packed: np.ndarray, g0: int, weights: np.ndarray):
    """Float64 beams [T', nbeam, F] of the gulp at ``g0``: ``np.fft``,
    ``fftshift`` and the weight product in complex128."""
    nup = 32
    v = unpack_complex_np(packed[g0:g0 + OFFLINE_GULP]).astype(np.complex128)
    T, nchan = OFFLINE_GULP // nup, v.shape[1]
    frames = v.reshape(T, nup, nchan, -1)
    fine = np.fft.fftshift(np.fft.fft(frames, axis=1), axes=1)
    x = fine.transpose(2, 1, 0, 3).reshape(nchan * nup, T, -1)  # [F, T, I]
    beams = np.matmul(x, weights.astype(np.complex128).transpose(1, 2, 0))
    return beams.transpose(1, 2, 0)


def fine_freqs(h: dict) -> np.ndarray:
    """upchan-bf's fine-channel labels at nup 32: coarse channel c's fine
    channel f at sfreq + c chan_bw + (f - 16) chan_bw / 32."""
    chan_bw = h["bw_hz"] / h["nchan"]
    return ((h["sfreq"] + np.arange(h["nchan"]) * chan_bw)[:, None]
            + (np.arange(32) - 16) * chan_bw / 32).reshape(-1)


def beams_close(got, want) -> bool:
    """The beam gate: rtol 1e-4, atol 1e-4 x max|truth|."""
    return bool(np.all(np.abs(got - want)
                       <= 1e-4 * np.abs(want) + 1e-4 * np.abs(want).max()))


def upchan_bf_phase(dev, path: str, tmp: Path, hdf5: bool) -> dict:
    """upchan-bf at nup 32, 4 beams, accumulated and ``--voltages``; gulp 0
    and the last gulp (weights recomputed at sample 1440) held to float64
    truths.  Returns the wall times."""
    h, data = TriggerFileSource(path).read()
    packed = data.reshape(h["ntime"], h["nchan"], h["nstand"], h["npol"])
    ngulp = h["ntime"] // OFFLINE_GULP
    last = (ngulp - 1) * OFFLINE_GULP
    chan_bw = h["bw_hz"] / h["nchan"]
    ra = [float(x) for x in OFFLINE_RA.split(",")]
    dec = [float(x) for x in OFFLINE_DEC.split(",")]
    cfg = offline.OfflineBeamConfig(
        nbeam=len(ra), ra_deg=ra, dec_deg=dec, nupchan=32,
        enz_positions=np.random.RandomState(0).standard_normal(
            [h["nstand"], 3]) * 100)
    freqs = fine_freqs(h)
    # the weights are recomputed at the first gulp at or past ntimestep
    # samples (1440 for 1000), and hold for the last gulp (1920)
    update = -(-cfg.ntimestep // OFFLINE_GULP) * OFFLINE_GULP
    check(update <= last < update + cfg.ntimestep,
          "[offline] no single weight recompute before the last gulp")
    w0 = offline.compute_offline_weights(cfg, freqs, h["sync_time"])
    w1 = offline.compute_offline_weights(cfg, freqs,
                                         h["sync_time"] + update / chan_bw)
    truth = {0: beam_truth(packed, 0, w0),
             ngulp - 1: beam_truth(packed, last, w1)}
    walls = {}
    for mode in ("accumulate", "voltages"):
        out = str(tmp / f"bf_{mode}.h5")
        argv = ["--datain", path, "--output", out, "--ra-array", OFFLINE_RA,
                "--dec-array", OFFLINE_DEC, "--nupchan", "32", "--gulp",
                str(OFFLINE_GULP), "--device", dev.type] + (
                    ["--voltages"] if mode == "voltages" else [])
        replay = run_cli(upchan_bf, argv, hdf5, walls, f"bf {mode}")
        if hdf5:
            import h5py

            with h5py.File(out, "r") as fh:
                got_freqs = fh["frequencies"][()]
                if mode == "accumulate":
                    outs = list(fh["power"][()])
                else:
                    b = np.stack([fh[f"beam{k}"][()]
                                  for k in range(len(ra))], 1)
                    outs = list(b.reshape(ngulp, -1, *b.shape[1:]))
        else:
            got_freqs, outs = replay.freqs, replay.outs
        check(np.array_equal(got_freqs, freqs), "[offline] bf frequencies")
        check(len(outs) == ngulp, f"[offline] bf {len(outs)} gulps")
        for g, want in truth.items():
            if mode == "accumulate":
                want = (np.abs(want) ** 2).mean(0)
            err = float(np.abs(outs[g] - want).max() / np.abs(want).max())
            check(np.isfinite(outs[g]).all() and beams_close(outs[g], want),
                  f"[offline] bf {mode} gulp {g} vs float64 truth "
                  f"(error {err:.3g} of max)")
            print(f"[offline] upchan-bf {mode}, gulp {g}: max error "
                  f"{err:.3g} of max|truth| (gate rtol 1e-4, atol 1e-4 x "
                  f"max)", flush=True)
    return walls


def host_vis(packed: np.ndarray, k: int, t1: int) -> np.ndarray:
    """Float64 visibilities of fine channel ``k`` at nup 2 over the first
    ``t1`` samples: coarse k // 2, fine k % 2 after the fftshift."""
    v = unpack_complex_np(packed[:t1, k // 2]).astype(np.complex128)
    fine = np.fft.fftshift(np.fft.fft(v.reshape(t1 // 2, 2, -1), axis=1),
                           axes=1)[:, k % 2]
    return fine.T @ fine.conj()


def hermitian(vis: np.ndarray) -> bool:
    return all(np.array_equal(vis[c:c + 16],
                              vis[c:c + 16].conj().transpose(0, 2, 1))
               for c in range(0, len(vis), 16))


def upchan_imag_phase(dev, path: str, tmp: Path, hdf5: bool) -> dict:
    """upchan-imag at nup 2 over the whole band: one integration of 1200
    frames, exact on ``IMAG_CHANNELS`` against float64 truths and
    Hermitian on all; then integrations of 720 frames, the first closing
    early and a partial tail, summing exactly to the whole."""
    h, data = TriggerFileSource(path).read()
    packed = data.reshape(h["ntime"], h["nchan"], h["nstand"], h["npol"])
    nfine = 2 * h["nchan"]
    walls, results = {}, {}
    for nframe in (1200, 720):
        out = str(tmp / f"vis_{nframe}.h5")
        argv = ["--datain", path, "--output", out, "--nupchan", "2",
                "--start-freq", "0", "--end-freq", str(nfine),
                "--nframe-per-integration", str(nframe), "--device",
                dev.type]
        replay = run_cli(upchan_imag, argv, hdf5, walls, f"imag {nframe}")
        if hdf5:
            import h5py

            with h5py.File(out, "r") as fh:
                results[nframe] = list(fh["vis"][()])
        else:
            results[nframe] = replay.out
    (full,), (early, tail) = results[1200], results[720]
    check(full.shape == (nfine, h["nstand"] * h["npol"],
                         h["nstand"] * h["npol"]),
          f"[offline] imag shape {full.shape}")
    for k in IMAG_CHANNELS:
        check(np.array_equal(full[k].astype(np.complex128),
                             host_vis(packed, k, h["ntime"])),
              f"[offline] imag fine channel {k} vs float64 truth")
    check(hermitian(full), "[offline] imag not Hermitian")
    for k in (0, nfine // 2 - 1, nfine - 1):
        check(np.array_equal(early[k].astype(np.complex128),
                             host_vis(packed, k, 2 * 720)),
              f"[offline] imag early integration, channel {k}")
    check(np.array_equal(early.astype(np.complex128) + tail, full),
          "[offline] imag early + tail != whole")
    print(f"[offline] upchan-imag, nup 2, {nfine} fine channels: equal to "
          f"the float64 truth on {len(IMAG_CHANNELS)} channels, Hermitian "
          f"on all; 720 + 480 frames sum exactly to the 1200", flush=True)
    return walls


def offline_times(dev, card: str, path: str) -> None:
    """Device ms a gulp of the three offline functions (CUDA events) and
    host s a gulp of the replay's read, staging + H2D + unpack and weight
    recompute."""
    t0 = time.perf_counter()
    h, data = TriggerFileSource(path).read()
    read_s = time.perf_counter() - t0
    packed = data.reshape(h["ntime"], h["nchan"], h["nstand"], h["npol"])
    ngulp = h["ntime"] // OFFLINE_GULP
    stage = offline._stage((OFFLINE_GULP,) + packed.shape[1:], dev)
    h2d = []
    for g in range(ngulp):
        t0 = time.perf_counter()
        gulp = offline._gulp_to_device(
            packed[g * OFFLINE_GULP:(g + 1) * OFFLINE_GULP], dev, stage)
        torch.cuda.synchronize()
        h2d.append(time.perf_counter() - t0)
    chan_bw = h["bw_hz"] / h["nchan"]
    nbeam = len(OFFLINE_RA.split(","))
    cfg = offline.OfflineBeamConfig(
        nbeam=nbeam, ra_deg=[0.0] * nbeam, dec_deg=[37.0] * nbeam,
        enz_positions=np.random.RandomState(0).standard_normal(
            [h["nstand"], 3]) * 100)
    freqs = fine_freqs(h)
    t0 = time.perf_counter()
    w = torch.from_numpy(offline.compute_offline_weights(
        cfg, freqs, SYNC_TIME)).to(dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    print(f"[{card}] offline replay host time a gulp of {OFFLINE_GULP} "
          f"spectra: file read {read_s / ngulp:.4f} s, pinned staging + "
          f"H2D + unpack {min(h2d):.4f}-{max(h2d):.4f} s, weight recompute "
          f"({nbeam} beams x {len(freqs)} fine channels x {h['nstand'] * 2} "
          f"inputs) {weights_s:.4f} s", flush=True)
    ni = h["nstand"] * h["npol"]
    c8 = 8  # bytes of a complex64
    fine = offline.upchannelize_gulp(gulp, 32)
    up_ms = cuda_ms(lambda: offline.upchannelize_gulp(gulp, 32), 10)
    up_b = bound(2 * gulp.numel() * c8, 5 * gulp.numel() * math.log2(32),
                 "fp32")
    bf_ms = cuda_ms(lambda: offline.apply_weights_and_sum(fine, w), 10)
    T, F = fine.shape[0], fine.shape[1] * fine.shape[2]
    bf_b = bound((fine.numel() + w.numel() + T * nbeam * F) * c8,
                 8 * T * nbeam * F * ni, "fp32")
    del fine
    sel = offline.upchan_select_gulp(gulp, 2, 0, 2 * h["nchan"])
    acc = offline.correlate_offline(sel)
    co_ms = cuda_ms(lambda: offline.correlate_offline(sel, acc), 5)
    T, C = sel.shape[0], sel.shape[1]
    co_b = bound((sel.numel() + 2 * acc.numel()) * c8,
                 8 * C * ni * ni * T, "fp32")
    for name, ms, b, what in (
            ("upchannelize_gulp", up_ms, up_b, "nup 32, FFT of the fine "
             "axis + fftshift + layout copy"),
            ("apply_weights_and_sum", bf_ms, bf_b, f"{nbeam} beams, one "
             f"complex64 bmm over {F} fine channels"),
            ("correlate_offline", co_ms, co_b, f"nup 2, {C} fine channels "
             f"x {ni}^2 x {T} frames added in place, "
             f"{8 * C * ni * ni * T / 1e9:.0f} GFLOP")):
        print(f"[{card}] offline {name} ({what}): {ms:.3f} ms a gulp; bound "
              f"{b['bound_ms']:.3f} ms by {b['bound_by']} (FP32 67 TFLOP/s, "
              f"3.35 TB/s)", flush=True)
    del sel, acc, gulp, w


def rx_process(module: str, argv: list, port: int, outdir: Path):
    """``python -m`` of a receiver script on 127.0.0.1:``port`` writing
    into ``outdir``; returns once it holds the port."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"caltech_bifrost_dsp_tpu_torch.scripts."
         f"{module}", "--ip", "127.0.0.1", "--port", str(port), "--outpath",
         str(outdir)] + argv, cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 60
    while not udp_bound(port):
        if proc.poll() is not None:
            raise RuntimeError(f"FAILED: [receivers] {module} exited "
                               f"{proc.returncode}: {proc.stdout.read()}")
        check(time.monotonic() < deadline, f"[receivers] {module} never "
              f"bound port {port}")
        time.sleep(0.02)
    return proc


def udp_bound(port: int) -> bool:
    """Whether a socket holds UDP ``port`` (from ``/proc/net/udp``, so
    that looking never takes the port itself)."""
    lines = Path("/proc/net/udp").read_text().splitlines()[1:]
    return any(int(ln.split()[1].rsplit(":", 1)[1], 16) == port
               for ln in lines)


def rx_file(proc, module: str, outdir: Path, timeout_s: float = 180):
    """Wait for a receiver process; the one file it wrote (meta, raw)."""
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise RuntimeError(f"FAILED: [receivers] {module} timed out: {out}")
    check(proc.returncode == 0, f"[receivers] {module} exit "
          f"{proc.returncode}: {out}")
    files = list(outdir.iterdir())
    check(len(files) == 1, f"[receivers] {module} wrote {files}")
    with open(files[0], "rb") as fh:
        meta = json.loads(fh.readline().decode())
        raw = fh.read()
    return files[0].name, meta, raw


def run_receivers(dev, card: str, blocks, gains_np, truth, slow,
                  tmp: Path) -> dict:
    """One driver run at full width whose subselection, PBEAM and COR
    streams go over loopback to ``corr_part_rx``, ``beam_rx --capture``
    and ``corr_rx --cor-fmt``, each ``python -m`` in its own process; every
    file equal to the driver path's truths, no packet lost.  Returns the
    launch counts."""
    cfg = RECORD_CFG
    nwin = len(blocks)
    nco = cfg.nchan // cfg.nchan_sum
    nb2 = cfg.nbeam // 2
    nseq = nwin * cfg.acc_len // cfg.ntime_sum
    ports, outs, procs = {}, {}, {}
    specs = {
        "corr_part_rx": ["-c", str(nco), "-b", str(cfg.nvis_out),
                         "--timeout", "180"],
        "beam_rx": ["--capture", "--nbeam", str(nb2), "--nseq", str(nseq),
                    "-c", str(cfg.nchan), "--timeout", "180"],
        "corr_rx": ["--cor-fmt", "-s", str(cfg.nstand), "-c",
                    str(cfg.nchan)],
    }
    for name in specs:
        ports[name] = free_port()
        outs[name] = tmp / name
        outs[name].mkdir()
    try:
        CommandBlock.reset_instance_counts()
        store = MemoryStore()
        dest = {n: ("127.0.0.1", p) for n, p in ports.items()}
        pipe = XEnginePipeline(
            cfg, GoldenSource(cfg, blocks), store=store, sync_time=SYNC_TIME,
            corr_outputs=[sink.CorrFullOutput(
                cfg, send=sink.UdpSender(*dest["corr_rx"]),
                max_mbps=RX_COR_MBPS, use_cor_fmt=True)],
            subsel_outputs=[sink.CorrPartOutput(
                cfg, send=sink.UdpSender(*dest["corr_part_rx"]))],
            pbeam_outputs=[sink.PBeamOutput(cfg, senders={
                b: sink.UdpSender(*dest["beam_rx"]) for b in range(nb2)})],
            device=dev.type)
        load_gains(pipe, store, gains_np)
        command(store, pipe.subsel_cmd.command_key, "bl",
                baselines=DRIVER_BASELINES)
        # the receivers start last: corr_rx waits at most 30 s for its
        # first packet, which comes with the slow dump
        for name, argv in specs.items():
            procs[name] = rx_process(name, argv, ports[name], outs[name])
        zero_counts()
        t0 = time.perf_counter()
        pipe.run(nwin * cfg.acc_len // cfg.ntime_gulp, timeout_s=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        files = {n: rx_file(procs[n], n, outs[n]) for n in specs}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    check((pipe.ndump_fast, pipe.ndump_slow) == (nwin, 1),
          f"[receivers] dumps {pipe.ndump_fast} fast, {pipe.ndump_slow} slow")
    # subselection: the integration after the in-flight one
    _, meta, raw = files["corr_part_rx"]
    w = meta["t0"] // cfg.acc_len
    check(meta["t0"] == cfg.acc_len and meta["acc_len"] == cfg.acc_len,
          f"[receivers] subsel t0 {meta['t0']}, acc_len {meta['acc_len']}")
    sub = np.frombuffer(raw, np.complex128).reshape(meta["shape"])
    check(np.array_equal(np.asarray(meta["baselines"], np.uint32),
                         np.asarray(DRIVER_BASELINES, np.uint32))
          and np.array_equal(sub.real.T, truth[w]["sub"][0])
          and np.array_equal(sub.imag.T, truth[w]["sub"][1]),
          f"[receivers] corr_part_rx file vs window {w}'s subselection")
    # power beams: every integration of every beam
    _, meta, raw = files["beam_rx"]
    power = np.frombuffer(raw, np.float32).reshape(meta["shape"])
    want = torch.cat([t["power"] for t in truth], 1).permute(1, 0, 2, 3)
    check(meta["seqs"] == list(range(0, nseq * cfg.ntime_sum,
                                     cfg.ntime_sum))
          and power_close(torch.from_numpy(power.copy()), want),
          "[receivers] beam_rx file vs the plain beam powers")
    # COR: the slow dump, Hermitian cube [s0, s1, p0, p1, chan]
    name, meta, raw = files["corr_rx"]
    cube = np.frombuffer(raw, np.complex128).reshape(meta["shape"])
    for k, plane in enumerate(slow):
        want = plane.reshape(cfg.nchan, cfg.nstand, cfg.npol, cfg.nstand,
                             cfg.npol).transpose(1, 3, 2, 4, 0)
        got = cube.imag if k else cube.real
        check(np.array_equal(got, want), f"[receivers] corr_rx file {name} "
              "vs the plain slow dump")
    del cube, raw
    nbl = cfg.nstand * (cfg.nstand + 1) // 2
    print(f"[receivers] corr_part_rx (window {w}, {cfg.nvis_out} "
          f"baselines), beam_rx ({nseq} integrations x {nb2} beams) and "
          f"corr_rx --cor-fmt ({nbl} packets paced at {RX_COR_MBPS} Mb/s), "
          f"each a process of its own: files equal to the truths, no packet "
          f"lost; driver {wall:.3f} s for {nwin} windows and the slow dump",
          flush=True)
    print(f"[{card}] receivers: COR slow dump of "
          f"{nbl * cor_packet_size(cfg) / 1e6:.1f} MB received by a Python "
          f"recv loop at the {RX_COR_MBPS} Mb/s pace", flush=True)
    return counts


def run_offline_path(dev, card: str, blocks, gains_np, truth, slow) -> dict:
    """The eighth path, offline replay and reception: a full-width dump
    replayed by upchan-bf and upchan-imag on the card, the offline
    functions timed, then the product receivers as processes.  Returns the
    launch counts (the offline functions launch none of the port's
    kernels; the receivers' driver run does)."""
    tmp = record_dir()
    hdf5 = have_h5py()
    try:
        if not hdf5:
            print("[offline] h5py is not installed: the HDF5 writers are "
                  "not run; the CLIs' replays run on the card without them "
                  "and the same gates hold their outputs", flush=True)
        zero_counts()
        path = offline_dump(tmp, blocks[0])
        walls = upchan_bf_phase(dev, path, tmp, hdf5)
        walls.update(upchan_imag_phase(dev, path, tmp, hdf5))
        offline_counts = read_counts()
        sky = LWA352.acc_len / LWA352.spectra_rate_hz
        print(f"[{card}] offline CLI wall times over the {sky * 1e3:.1f} ms "
              f"of sky in the dump"
              + ("" if hdf5 else " (replay without the HDF5 writers)") + ": "
              + ", ".join(f"{k} {v:.3f} s ({v / sky:.2f}x)"
                          for k, v in walls.items() if "MB/s" not in k)
              + "; HDF5 writers " + (", ".join(
                  f"{k.removesuffix(' HDF5 MB/s')} {v:.1f} MB/s"
                  for k, v in walls.items() if "MB/s" in k) if hdf5
                  else "not run (no h5py)"), flush=True)
        offline_times(dev, card, path)
        counts = run_receivers(dev, card, blocks, gains_np, truth, slow, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not any(offline_counts.values()),
          f"[offline] kernels launched by the offline CLIs: {offline_counts}")
    for name in (DEFAULT_CORR, "beamform_products", "subsel_gather"):
        check(counts[name] > 0, f"[receivers] {name} not launched")
    print(f"[offline] kernel launches: {counts}", flush=True)
    return counts


#: the ninth path: two processes, each with two shards on ``cuda:0``, one
#: 2x2 mesh between them, each placement in turn
MULTIHOST_PLACEMENTS = ("chan", "time")
MULTIHOST_DEVICES = ["cuda:0"] * 2
MULTIHOST_TIMEOUT_S = 600


def beam_gains_np() -> list:
    """The integer beam gains every path commands (seed 0xBF)."""
    rng = np.random.RandomState(0xBF)
    shape = (LWA352.nchan, LWA352.nbeam, LWA352.ninput)
    return [rng.randint(-8, 9, shape).astype(np.float32) for _ in range(2)]


class MultihostInputs:
    """What every process of the ninth path passes to the sharded steps:
    the first golden window gulp by gulp, the gains, the selection, and
    one int8 FX window with its carried tail (the mesh path's, made on
    the card from the same seed)."""

    def __init__(self, dev, block: np.ndarray, gains_np, qs: float):
        cfg = MESH_CFG
        self.window = torch.from_numpy(block.reshape(
            cfg.acc_len, cfg.nchan, cfg.ninput)).to(dev)
        self.gains = bf.BeamGains(*(torch.from_numpy(x).to(dev)
                                    for x in gains_np))
        self.pairs = torch.from_numpy(PAIRS).to(dev)
        self.fx = MeshFx(dev, qs, self.gains, self.pairs)

    def gulps(self):
        cfg = MESH_CFG
        g, n = cfg.ntime_gulp, cfg.acc_len // cfg.ntime_gulp
        for k in range(n):
            yield k == 0, k == n - 1, self.window[k * g:(k + 1) * g]


def multihost_products(mesh, x: MultihostInputs, gather) -> tuple:
    """One golden X/B window gulp by gulp (the fast partials carried
    between gulps, the fast dump, the first slow update) and one int8 FX
    window through the stateful sharded steps on ``mesh``.  Returns every
    product through ``gather`` (``Sharded`` -> CPU tensor) and the wall
    seconds of each window (to the last kernel's end)."""
    cfg, walls, keep = MESH_CFG, {}, {}
    state = pm.zero_sharded_state(cfg, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, (first, last, gulp) in enumerate(x.gulps()):
        step = pm.xengine_sharded_state_fn(cfg, mesh, first, last, True)
        state, out, vlbi = step(state, gulp, x.gains, x.pairs)
        keep[f"xb power {k}"], keep[f"xb vlbi {k}"] = out.bf_power, vlbi
    keep.update({"xb fast re": out.vis.real, "xb fast im": out.vis.imag,
                 "xb subsel re": out.subsel.real,
                 "xb subsel im": out.subsel.imag,
                 "xb slow re": state[1].real, "xb slow im": state[1].imag})
    torch.cuda.synchronize()
    walls["X/B"] = time.perf_counter() - t0
    fx = x.fx
    step = pm.fx_sharded_state_fn(fx.cfg, mesh, True, True, True)
    t0 = time.perf_counter()
    _, out, vlbi = step(pm.zero_sharded_state(fx.cfg, mesh),
                        *fx.sharded_args(), x.gains, x.pairs)
    torch.cuda.synchronize()
    walls["FX"] = time.perf_counter() - t0
    keep.update({"fx power": out.bf_power, "fx vlbi": vlbi,
                 "fx fast re": out.vis.real, "fx fast im": out.vis.imag,
                 "fx subsel re": out.subsel.real,
                 "fx subsel im": out.subsel.imag})
    return {k: gather(v) for k, v in keep.items()}, walls


def digests(products: dict) -> dict:
    """SHA-256 of each product's bytes, with its dtype and shape."""
    return {k: f"{v.dtype} {tuple(v.shape)} " + hashlib.sha256(
        v.contiguous().numpy().data).hexdigest() for k, v in products.items()}


def multihost_step_ms(dev, mesh, x: MultihostInputs) -> float:
    """CUDA-event device ms of a dump call of the sharded X/B step on one
    2400-spectra block (the mesh path's timing), in this process."""
    cfg = MESH_CFG
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    packed = torch.randint(0, 256, (cfg.acc_len, cfg.nchan, cfg.ninput),
                           generator=g, device=dev, dtype=torch.uint8)
    state = pm.zero_sharded_state(cfg, mesh)
    step = pm.xengine_sharded_state_fn(cfg, mesh, True, True, False)
    return cuda_ms(lambda: step(state, packed, x.gains, x.pairs), 3)


def multihost_worker(argv) -> int:
    """``chip_smoke.py --multihost-worker RANK PORT QS``: one of the
    ninth path's two processes.  Joins the gloo group at
    ``127.0.0.1:PORT``, makes the inputs every process passes (the first
    golden window, the gains, the FX window of requant gain ``QS``, a float
    in hex), and per placement runs :func:`multihost_products` on the
    global 2x2 mesh (launch counts set to 0 just before, read just after),
    then times a dump call; prints one ``MULTIHOST`` JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    rank, port, qs = int(argv[0]), int(argv[1]), float.fromhex(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    _build.library()
    multihost.initialize(f"127.0.0.1:{port}", 2, rank)
    cfg = MESH_CFG
    x = MultihostInputs(dev, golden_windows(DRIVER_CFG, 1)[0],
                        beam_gains_np(), qs)
    report = {}
    for placement in MULTIHOST_PLACEMENTS:
        mesh = multihost.global_mesh(placement=placement,
                                     devices=MULTIHOST_DEVICES)
        zero_counts()
        got, walls = multihost_products(mesh, x,
                                        multihost.process_allgather)
        counts = read_counts()
        traffic = json.loads(json.dumps(mesh.traffic))
        mesh.traffic.clear()
        step_ms = multihost_step_ms(dev, mesh, x)
        report[placement] = {
            "digests": digests(got), "counts": counts, "walls": walls,
            "traffic": traffic, "step_ms": step_ms,
            "step_traffic": mesh.traffic,
            "local": mesh.local_coords(),
            "chan_range": multihost.local_channel_range(cfg, mesh)}
        del got
    torch.distributed.destroy_process_group()
    print("MULTIHOST " + json.dumps({"rank": rank, "report": report}),
          flush=True)
    return 0


def run_multihost_path(dev, card: str, block: np.ndarray, gains_np,
                       qs: float, mesh_ms: dict) -> dict:
    """The ninth path: two processes of this script (gloo, staged through
    pinned host memory) run one 2x2 mesh over ``cuda:0`` at full width,
    each placement in turn, on the inputs this process makes from
    ``block`` (the first golden window, which each worker makes again from
    its seed); every product they gather equal byte for byte to the
    single-process 2x2 mesh's.  Returns the launch counts summed over both
    processes and placements."""
    x = MultihostInputs(dev, block, gains_np, qs)
    want, walls = multihost_products(pm.make_mesh(
        2, 2, devices=["cuda:0"] * 4), x, lambda s: pm.unshard(s).cpu())
    want = digests(want)
    print(f"[{card}] multihost: the single-process 2x2 mesh on the same "
          f"inputs, X/B window {walls['X/B']:.3f} s, FX window "
          f"{walls['FX']:.3f} s wall; {len(want)} products", flush=True)
    del x
    torch.cuda.empty_cache()
    procs, late = [], None
    with tempfile.TemporaryDirectory() as tmp:
        logs = [Path(tmp) / f"worker{rank}.log" for rank in range(2)]
        try:
            port = free_tcp_port()
            t0 = time.perf_counter()
            for rank, log in enumerate(logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         "--multihost-worker", str(rank), str(port),
                         qs.hex()],
                        stdout=f, stderr=subprocess.STDOUT))
            for p in procs:
                p.wait(max(1.0, t0 + MULTIHOST_TIMEOUT_S
                           - time.perf_counter()))
            wall = time.perf_counter() - t0
        except subprocess.TimeoutExpired as e:
            late = e
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = [log.read_text() for log in logs]
    reports = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST ")]
        if late or p.returncode or not line:
            print(out, flush=True)
            raise RuntimeError(f"FAILED: multihost worker {rank} exited "
                               f"{p.returncode}" + (f" ({late})" if late
                                                    else ""))
        reports.append(json.loads(line[-1][len("MULTIHOST "):])["report"])
    total = {name: 0 for name in KERNELS}
    for placement in MULTIHOST_PLACEMENTS:
        label = f"[multihost {placement}]"
        r0, r1 = (r[placement] for r in reports)
        for got in (r0["digests"], r1["digests"]):
            bad = sorted(k for k in want if got.get(k) != want[k])
            check(not bad and got.keys() == want.keys(),
                  f"{label} products differ from the single-process "
                  f"2x2 mesh's: {bad}")
        counts = {k: r0["counts"][k] + r1["counts"][k] for k in KERNELS}
        # every process runs its shards' correlator, beamformer and
        # channelizer; the gather runs where shard (0, c) is
        for name in ("corr_blk", "beamform_products", channelizer(FX_CFG)):
            check(r0["counts"][name] > 0 and r1["counts"][name] > 0,
                  f"{label} {name} not launched in both processes")
        check(counts["subsel_gather"] > 0, f"{label} subsel_gather not "
              "launched")
        total = {k: total[k] + counts[k] for k in KERNELS}
        vols = multihost.split_volumes(LWA352, 2, 2, placement)
        print(f"{label} 2 processes x 2 shards of cuda:0, gloo: every "
              f"product gathered in both processes ({len(want)}: fast, "
              f"slow, subsel exact int32; power, VLBI) byte for byte the "
              f"single-process 2x2 mesh's; shards {r0['local']} and "
              f"{r1['local']}, channels {r0['chan_range']} and "
              f"{r1['chan_range']}; kernel launches {counts}", flush=True)
        for rank, r in enumerate((r0, r1)):
            sent = {k: v["sent_bytes"] for k, v in r["traffic"].items()}
            secs = {k: round(v["transfer_s"], 4)
                    for k, v in r["traffic"].items()}
            print(f"[{card}] multihost {placement} process {rank}: wall X/B "
                  f"window (5 gulps) {r['walls']['X/B']:.3f} s, FX window "
                  f"{r['walls']['FX']:.3f} s; bytes sent to the other "
                  f"process by collective {sent}, seconds staging and in "
                  f"gloo {secs}; dump call {r['step_ms']:.3f} ms device "
                  f"(CUDA events; the single-process 2x2 mesh "
                  f"{mesh_ms['2x2']:.3f} ms in this run), "
                  f"its traffic {r['step_traffic']}", flush=True)
        print(f"{label} split_volumes(LWA352, 2, 2, {placement!r}), bytes "
              f"per window with every shard on a device of its own: "
              + json.dumps({v["collective"]: {
                  "cross": v["cross_process_bytes_per_window"],
                  "in": v["in_process_bytes_per_window"]}
                  for v in vols["collectives"]}), flush=True)
    print(f"[{card}] multihost: both workers {wall:.1f} s from start to "
          f"exit", flush=True)
    return total


#: the tenth path's pace for the capture runs, Gb/s: what the wire path
#: offers over the card's host's loopback
BENCH_WIRE_GBPS = WIRE_GBPS[0]
#: the bench scripts' JSON keys, as the JAX scripts print them
PIPELINE_KEYS = {"metric", "value", "unit", "vs_baseline", "gulps",
                 "partial", "compute_thread", "device", "power_limit"}
STAGE_KEYS = {"stage", "measured_ms", "roofline_ms", "binding",
              "sol_fraction"}


def bench_json(module, argv: list, label: str) -> dict:
    """``module.main(argv)`` with its standard output caught: its JSON line,
    printed on a line of its own; a non-zero exit fails the path."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0 and bool(lines), f"[bench] {label} exited {rc}")
    row = json.loads(lines[-1])
    print(json.dumps(row), flush=True)
    return row


def check_numbers(row: dict, keys, label: str, positive=True) -> None:
    """Every value under ``keys`` a finite number (and positive)."""
    for k in keys:
        v = row[k]
        check(isinstance(v, (int, float)) and not isinstance(v, bool)
              and math.isfinite(v) and (v > 0 or not positive),
              f"[bench] {label}: {k} = {v!r}")


def bench_launches(module, argv: list, label: str, total: dict) -> tuple:
    """:func:`bench_json` with the launch counts set to 0 just before and
    read just after; they add to ``total``."""
    zero_counts()
    row = bench_json(module, argv, label)
    counts = read_counts()
    for name in KERNELS:
        total[name] += counts[name]
    return row, counts


def run_bench_path(card: str) -> tuple[dict, dict]:
    """The tenth path: the port's five bench scripts through their
    ``main()`` at the full LWA-352 width, short runs, each JSON line printed
    and checked: ``bench_step`` (5 windows); ``bench_pipeline`` on the card
    (the least run, four fast windows), with the stub device at the step's
    measured ms and ``--skip-write``, and with the stub device fed by native
    capture at the wire path's pace (and on the card once more with
    ``--skip-write``, without the source's cost); ``bench_stages`` (every
    stage, no
    ``sol_fraction`` over 1.05); ``bench_ingest`` (20 gulps at that pace,
    plain and with the upload); ``bench_scaling`` (1x1, 1x2, 2x2 on this
    card).  Returns (launches over the path, bench_step's row)."""
    total = {name: 0 for name in KERNELS}
    walls = {}
    t0 = time.perf_counter()
    step, counts = bench_launches(bench_step, ["--windows", "5"],
                                  "bench_step", total)
    check({"metric", "value", "unit", "vs_baseline", "ms_per_window",
           "device", "power_limit"} <= set(step), "[bench] bench_step keys")
    check_numbers(step, ("value", "vs_baseline", "ms_per_window"),
                  "bench_step")
    for name in (DEFAULT_CORR, "beamform_products", "subsel_gather"):
        check(counts[name] > 0, f"[bench] bench_step launched no {name}")
    walls["step"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    dev_run, counts = bench_launches(bench_pipeline, ["--seconds", "0"],
                                     "bench_pipeline on the card", total)
    check(counts[DEFAULT_CORR] > 0,
          f"[bench] bench_pipeline on the card launched no {DEFAULT_CORR}")
    # the same without the source's generation cost: H2D and the step
    dev_zero, counts = bench_launches(
        bench_pipeline, ["--seconds", "0", "--skip-write"],
        "bench_pipeline on the card --skip-write", total)
    check(counts[DEFAULT_CORR] > 0, f"[bench] bench_pipeline on the card "
          f"--skip-write launched no {DEFAULT_CORR}")
    stub, counts = bench_launches(
        bench_pipeline, ["--stub-device", f"{step['ms_per_window']:.3f}",
                         "--skip-write", "--seconds", "5"],
        "bench_pipeline --stub-device --skip-write", total)
    check(not any(counts.values()),
          f"[bench] the stub run launched kernels: {counts}")
    delay_ns = int(16 * LWA352.nchan * LWA352.ninput * 8 / BENCH_WIRE_GBPS)
    udp, counts = bench_launches(
        bench_pipeline, ["--stub-device", f"{step['ms_per_window']:.3f}",
                         "--udp", "--delay-ns", str(delay_ns), "--seconds",
                         "0", "--port", str(free_port())],
        "bench_pipeline --stub-device --udp", total)
    check(not any(counts.values()),
          f"[bench] the stub capture run launched kernels: {counts}")
    for row, label in ((dev_run, "on the card"),
                       (dev_zero, "on the card, skip-write"), (stub, "stub"),
                       (udp, "stub over UDP")):
        check(PIPELINE_KEYS <= set(row), f"[bench] bench_pipeline {label} "
              f"keys {sorted(row)}")
        check_numbers(row, ("value", "vs_baseline", "gulps"),
                      f"bench_pipeline {label}")
        check_numbers(row["compute_thread"], ("acquire_s", "reserve_s",
                                              "process_s"),
                      f"bench_pipeline {label}", positive=False)
    check(not (dev_run["partial"] or dev_zero["partial"] or stub["partial"]),
          "[bench] a bench_pipeline run without capture was partial")
    check({"npkt", "nmissing", "loss_fraction"} == set(udp["capture"]),
          "[bench] bench_pipeline --udp capture keys")
    check_numbers(udp["capture"], ("loss_fraction", "nmissing"),
                  "bench_pipeline --udp", positive=False)
    print(f"[{card}] bench_pipeline, no sinks (no beams, no subselection): "
          f"on the card {dev_run['value']:.3f} Gb/s over "
          f"{dev_run['gulps']} gulps ({dev_zero['value']:.3f} with the "
          f"source's zeros, no generation cost); host half alone (stub device "
          f"{step['ms_per_window']:.3f} ms a window, skip-write) "
          f"{stub['value']:.3f} Gb/s; fed by native capture at "
          f"{BENCH_WIRE_GBPS} Gb/s offered {udp['value']:.3f} Gb/s, partial "
          f"{udp['partial']}, loss {udp['capture']['loss_fraction']:.3e} "
          f"({udp['capture']['nmissing']} packets missing)", flush=True)
    walls["pipeline"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    stages, _ = bench_launches(bench_stages, [],
                               "bench_stages", total)
    names = [r["stage"] for r in stages["stages"]]
    want = bench_stages.stage_models(LWA352, LWA352.nvis_out,
                                     LWA352.nvis_out)
    check(sorted(names) == sorted(want), f"[bench] bench_stages ran {names}")
    for r in stages["stages"]:
        check(STAGE_KEYS <= set(r), f"[bench] stage keys {sorted(r)}")
        check_numbers(r, ("measured_ms", "roofline_ms", "sol_fraction"),
                      r["stage"])
        check(r["sol_fraction"] <= 1.05, f"[bench] {r['stage']} at "
              f"{r['sol_fraction']:.3f} of its bound: the model or the "
              f"timing is wrong")
        check(r["binding"] in ("bytes", "int8", "bf16", "fp64", "fp32"),
              f"[bench] {r['stage']} binding {r['binding']}")
    walls["stages"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    for argv, label in (([], "bench_ingest"), (["--h2d"],
                                               "bench_ingest --h2d")):
        row, _ = bench_launches(bench_ingest, [
            "--ngulp", "20", "--delay-ns", str(delay_ns), "--port",
            str(free_port())] + argv, label, total)
        check_numbers(row, ("value", "vs_baseline", "gulps"), label)
        check_numbers(row, ("loss_fraction",), label, positive=False)
        print(f"[{card}] {label}: {row['value']:.3f} Gb/s over "
              f"{row['gulps']} gulps at {BENCH_WIRE_GBPS} Gb/s offered, loss "
              f"{row['loss_fraction']:.3e}", flush=True)
    walls["ingest"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    sc, _ = bench_launches(bench_scaling, [
        "--production", "--meshes", "1x1,1x2,2x2", "--niter", "2"],
        "bench_scaling", total)
    check(sorted(sc["devices"]) == ["1x1", "1x2", "2x2"] and sc["cards"] == 1,
          f"[bench] bench_scaling meshes {sorted(sc['devices'])}, cards "
          f"{sc['cards']}")
    for key in ("per_chip_efficiency", "constant_compute_efficiency"):
        check_numbers(sc[key], sorted(sc[key]), f"bench_scaling {key}")
    for key, row in sc["devices"].items():
        check_numbers(row, ("sec_per_window", "msamples_per_s"),
                      f"bench_scaling {key}")
    walls["scaling"] = time.perf_counter() - t1
    print(f"[{card}] bench path launches: {total}; wall by part: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()),
          flush=True)
    return total, step


#: the eleventh path: the soak's full leg cut to fit the smoke, seconds
#: asked, gulps a second (1.04 Gb/s) and slow dumps of two fast windows;
#: segment B still runs past the recovery margins (95 gulps)
SOAK_SECONDS = 40.0
SOAK_RATE = 2.0
SOAK_ACC_LEN_SLOW = 4800


def load_demo():
    """``examples/demo_torch.py`` as a module."""
    path = Path(__file__).resolve().parent / "examples" / "demo_torch.py"
    spec = importlib.util.spec_from_file_location("demo_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_soak_path(card: str) -> dict:
    """The eleventh path: ``scripts/soak.py``'s full leg at the full
    LWA-352 width (``native.CaptureSource`` fed by a blaster process,
    every sink live to a receiver process, the 1000-gulp break, a trigger
    through the control client replayed from its file, the monitor), cut
    to ``SOAK_SECONDS`` at ``SOAK_RATE`` gulps a second with slow dumps of
    ``SOAK_ACC_LEN_SLOW`` spectra; every fast window's subselection and
    every slow dump exact against the plain correlator's truth on both
    sides of the break, the memory gates held.  Then the demo on the card.
    The soak's counts are zeroed after its warm-up pipeline and read as
    its paced run ends, the demo's zeroed and read around it; returns
    their sum."""
    tmp = record_dir()
    try:
        torch.cuda.empty_cache()
        rec, _ = soak.run_leg("full", SOAK_SECONDS, SOAK_RATE, "cuda",
                              acc_len_slow=SOAK_ACC_LEN_SLOW,
                              dump_dir=str(tmp), on_start=zero_counts)
        counts = read_counts()
        zero_counts()
        demo = load_demo().run("cuda", str(tmp))
        demo_counts = read_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    keys = ("actual_duration_s", "rate_gulps_per_s", "ngulp",
            "segment_a_gulps", "segment_b_gulps", "nmissing", "nseq",
            "ndump_fast", "ndump_slow", "ndumps_pre_break",
            "ndumps_post_break", "subsel_windows", "subsel_windows_exact",
            "slow_dumps_exact", "wire_packets", "rss_warm_highwater_mb",
            "rss_end_highwater_mb", "rss_growth_mb", "reserved_quarter_mb",
            "reserved_end_mb", "reserved_growth_mb", "quarter_mark_s",
            "dump_file", "reduced", "failures")
    print(f"[soak] {json.dumps({k: rec[k] for k in keys})}", flush=True)
    print(f"[soak] device trajectory [s, allocated, reserved, pinned MB]: "
          f"{rec['device_trajectory_s_mb']}", flush=True)
    check(rec["pass"], f"[soak] gates failed: {rec['failures']}")
    check(rec["nmissing"] == 0 and rec["nseq"] >= 2
          and rec["ndumps_pre_break"] > 0 and rec["ndumps_post_break"] > 0
          and rec["subsel_windows_exact"] == rec["subsel_windows"]
          == rec["ndump_fast"] and rec["slow_dumps_exact"]
          == rec["ndumps_pre_break"] + rec["ndumps_post_break"],
          f"[soak] record {rec}")
    print(f"[{card}] soak, full width: {rec['ngulp']} gulps at "
          f"{rec['rate_gulps_per_s']} a second in "
          f"{rec['actual_duration_s']} s, 0 packets missing, "
          f"{rec['nseq']} sequences; {rec['subsel_windows']} fast windows "
          f"and {rec['slow_dumps_exact']} slow dumps "
          f"({rec['ndumps_pre_break']} before the break, "
          f"{rec['ndumps_post_break']} after) exact; RSS high-water grew "
          f"{rec['rss_growth_mb']} MB (limit {soak.RSS_GROWTH_MB}), "
          f"memory_reserved {rec['reserved_growth_mb']} MB (limit "
          f"{rec['reserved_limit_growth_mb']})", flush=True)
    check(demo["check_failures"] == 0 and demo["checks"] > 0,
          f"[demo] golden checks on the card: {demo}")
    print(f"[demo] examples/demo_torch.py on the card: {demo}", flush=True)
    for name in (DEFAULT_CORR, "beamform_products", "subsel_gather"):
        check(counts[name] > 0, f"[soak] {name} not launched by the soak's "
                                f"paced pipeline")
    check(sum(demo_counts.values()) > 0, "[demo] no kernel launched")
    print(f"[soak] kernel launches of the paced pipeline: {counts}; of the "
          f"demo: {demo_counts}", flush=True)
    return {name: counts[name] + demo_counts[name] for name in KERNELS}


def timed(walls: dict, name: str, fn, *args):
    """``fn(*args)``, its wall time into ``walls[name]``."""
    t0 = time.perf_counter()
    out = fn(*args)
    walls[name] = time.perf_counter() - t0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_name()
    print(card, flush=True)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    walls = {"build": time.perf_counter() - t0}
    results = {name: {} for name in KERNELS}
    timed(walls, "kernels", phase_kernels, dev, card, results)
    timed(walls, "triu", phase_triu, dev, card, results)
    timed(walls, "pfb_direct", phase_pfb_direct, dev, card, results)
    timed(walls, "pfb_fft", phase_pfb_fft, dev, card, results)

    gains_np = beam_gains_np()
    # path 1, X/B: packed golden input
    blocks = golden_windows(DRIVER_CFG, 3)
    zero_counts()
    t1 = time.perf_counter()
    run_geometry(dev, DRIVER_CFG, blocks, gains_np)
    walls["X/B"] = time.perf_counter() - t1
    # the golden-parity gate: the production step against the host's truth
    t1 = time.perf_counter()
    parity = {"geometries": {}}
    for nchan in (192, 184):
        check(gpu_parity.run_geometry(nchan, 3 * DRIVER_CFG.acc_len,
                                      LWA352.nstand, parity, "cuda"),
              f"[parity] {nchan}c: a window or the slow sum failed")
    check(gpu_parity.run_fx(parity, "cuda"), "[parity] FX leg failed")
    walls["parity"] = time.perf_counter() - t1
    xb = read_counts()
    for name in (DEFAULT_CORR, "beamform_products", "subsel_gather"):
        check(xb[name] > 0, f"kernel {name} not launched by the X/B path")
    print(f"X/B path kernel launches: {xb}", flush=True)
    # path 2, FX: raw ADC through the channelizer
    fx, qs = timed(walls, "FX", run_fx_path, dev, gains_np)
    # path 3, F-engine: the channelizer alone at 4096 channels
    fe = timed(walls, "F-engine", run_fengine, dev, card, results)
    # path 4, the operator entry point's threaded driver
    dr, truth, slow, ref = timed(walls, "driver", run_driver_path, dev, card,
                                 blocks, gains_np)
    # path 5, the device mesh: sharded programs and the mesh driver
    me, mesh_ms = timed(walls, "mesh", run_mesh_path, dev, card, blocks,
                        gains_np, qs, truth, slow, ref)
    # path 6, the wire: C++ COR out, native capture in
    wi = timed(walls, "wire", run_wire_path, dev, card, blocks, gains_np, qs,
               truth, slow, ref)
    # the correlator schedules without an engine name
    sc = timed(walls, "schedules", run_schedules_path, dev, DRIVER_CFG,
               blocks, slow)
    # path 7, control and record: the transient recorder, the CLI under the
    # host manager, the etcd3 wire
    rc = timed(walls, "record", run_record_path, dev, card, blocks,
               gains_np, qs, truth)
    # path 8, offline replay and reception: the upchannelizer CLIs on a
    # full-width dump, the product receivers as processes
    of = timed(walls, "offline", run_offline_path, dev, card, blocks,
               gains_np, truth, slow)
    del truth, slow
    # path 9, one mesh across two processes on this card
    mh = timed(walls, "multihost", run_multihost_path, dev, card,
               blocks[0], gains_np, qs, mesh_ms)
    del blocks
    # path 10, the measuring entry points: the five bench scripts
    be, step = timed(walls, "bench", run_bench_path, card)
    # path 11, the soak's full leg and the demo
    so = timed(walls, "soak", run_soak_path, card)
    launches = {name: xb[name] + fx[name] + fe[name] + dr[name] + me[name]
                + wi[name] + sc[name] + rc[name] + of[name] + mh[name]
                + be[name] + so[name] for name in KERNELS}
    print(f"kernel launches over the eleven paths and the schedules run: "
          f"{launches}", flush=True)

    t1 = time.perf_counter()
    cfg = LWA352
    state = init_state(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    packed = torch.randint(0, 256, (cfg.acc_len, cfg.nchan, cfg.ninput),
                           generator=g, device=dev, dtype=torch.uint8)
    gains = bf.BeamGains(*(torch.from_numpy(x).to(dev) for x in gains_np))
    pairs = torch.from_numpy(PAIRS).to(dev)
    step_ms = step["ms_per_window"]
    print(f"[{card}] xengine_step, one 2400-spectra window at 704 inputs x "
          f"192 channels (scripts/bench_step.py, {step['windows']} windows): "
          f"{step_ms:.3f} ms per window ({step['value']:.1f} Gb/s of packed "
          f"input; the real-time bar is {cfg.input_gbps:.1f} Gb/s)",
          flush=True)
    tcfg = cfg.replace(**DRIVER_ENGINES["pallas_triu"])
    triu_ms = cuda_ms(lambda: xengine_step(state, packed, gains, pairs, True,
                                           True, False, tcfg), 5)
    print(f"[{card}] xengine_step per window, pallas_triu engines "
          f"(corr_triu.cu + in-place adds): {triu_ms:.3f} ms; default "
          f"engines (corr_acc.cu, {DEFAULT_CORR}): {step_ms:.3f} ms",
          flush=True)
    del packed
    fcfg = FX_CFG
    L = 2 * fcfg.nchan
    adc = torch.randint(-90, 91, ((fcfg.acc_len + fcfg.pfb_ntap - 1) * L,
                                  fcfg.ninput), generator=g, device=dev,
                        dtype=torch.int8)
    window = torch.from_numpy(pfb.pfb_window(fcfg.nchan,
                                             fcfg.pfb_ntap)).to(dev)
    scale = torch.tensor(qs, device=dev)
    fx_ms = cuda_ms(lambda: fx_step(state, adc, window, scale, gains, pairs,
                                    True, True, False, fcfg), 5)
    msps = fcfg.acc_len * L / (fx_ms * 1e-3) / 1e6
    bar = fcfg.fs_hz / fcfg.npipeline / 1e6
    print(f"[{card}] fx_step (int8 ADC -> pfb_direct -> X/B), one "
          f"2400-spectra window at 704 inputs x 192 channels: {fx_ms:.3f} ms "
          f"per window of {fcfg.acc_len / fcfg.spectra_rate_hz * 1e3:.1f} ms "
          f"of sky; {msps:.2f} Msamples/s per input against the "
          f"{bar:.3f} bar ({msps / bar:.2f}x)", flush=True)

    walls["step times"] = time.perf_counter() - t1
    print(f"[{card}] wall time by phase: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f"; {time.perf_counter() - t0:.1f} s from the build on",
          flush=True)

    kernels = [{"name": name, "route": spec["route"],
                "source": spec["source"], "replaces": spec["replaces"],
                **{k: spec[k] for k in ("also_replaces",) if k in spec},
                "launches": launches[name], "library_ms": NO_LIBRARY,
                **results[name],
                "tolerance": spec["tolerance"]}
               for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(sys.argv[2:]))
    sys.exit(main())
