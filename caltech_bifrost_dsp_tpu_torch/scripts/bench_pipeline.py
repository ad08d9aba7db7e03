"""Whole-pipeline throughput bench: host threads + H2D + device (port of
``caltech_bifrost_dsp_tpu/scripts/bench_pipeline.py``).

    python -m caltech_bifrost_dsp_tpu_torch.scripts.bench_pipeline \\
        [--seconds S] [--skip-write] [--stub-device MS [--udp [--fx]]]

Runs the threaded driver (:class:`..runtime.driver.XEnginePipeline`:
ingest -> fused step -> outputs) with no sinks on an unthrottled
``SyntheticSource(mode="ramp", target_throughput_gbps=1000)`` and reports
the sustained Gb/s of packed 4+4-bit input, the analog of the reference's
``DummySource(skip_write=True, target_throughput=...)`` downstream bench
(dummy_source_block.py:130-140).  With no sink the step computes no beams
and no subselection, as in the JAX driver.  ``--skip-write`` makes the
source emit zeros at no generation cost.

On the card (the default) a warm-up run of two fast windows comes first;
a second pipeline then takes over its state and is measured.  The run
lasts about ``--seconds`` of sky at the 25.9 Gb/s bar, rounded to whole
fast windows and never fewer than four.

``--stub-device MS`` replaces each step call with a sleep of MS ms per
fast window and zero products, on the CPU (no upload, no kernel, no
accumulator state): the host half alone, capture -> staging ring ->
compute thread -> output thread.  With ``--udp`` the port's native capture
engine (``io/native.py`` ``CaptureSource``, or ``AdcCaptureSource`` with
``--fx`` for int8 ADC frames, twice the packed bytes for the same sky and
so twice the bar) ingests snap2 packets sent over loopback by
``native.transmit_gulp`` from a thread, paced by ``--delay-ns`` every 16
time samples.  A UDP run whose capture loses a whole gulp cannot deliver
every gulp; the wait is bounded and the run reported with ``partial``.

Prints one JSON line with the JAX script's keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``gulps``, ``partial``, ``compute_thread``
``{acquire_s, reserve_s, process_s}``, the reference's perf taxonomy,
corr_block.py:453-457; ``stub_device_ms_per_window`` and ``capture
{npkt, nmissing, loss_fraction}`` where they apply) and the card's
``device`` and ``power_limit`` (None on a host without one, stub runs
only).  Without ``--stub-device`` it exits non-zero on a host without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

from ..config import LWA352
from ..io.source import SyntheticSource
from ..runtime.driver import XEnginePipeline
from ..utils.roofline import card_fields

#: the packed-voltage real-time bar per pipeline, Gb/s (BASELINE.md)
BAR_GBPS = 25.9


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="pipeline throughput bench")
    p.add_argument("--seconds", type=float, default=20.0,
                   help="approximate measurement duration")
    p.add_argument("--nstand", type=int, default=352)
    p.add_argument("--nchan", type=int, default=192)
    p.add_argument("--skip-write", action="store_true",
                   help="zero-filled gulps (no generation cost)")
    p.add_argument("--stub-device", type=float, default=None,
                   metavar="MS", help="replace the device call with a "
                   "MS-per-window sleep, on the CPU (the host half alone)")
    p.add_argument("--udp", action="store_true",
                   help="with --stub-device: ingest via the native C++ "
                        "capture engine over loopback (paced blaster)")
    p.add_argument("--fx", action="store_true",
                   help="with --udp: FX mode, int8 ADC frames through "
                        "AdcCaptureSource; the wire carries 2x the packed "
                        "bytes for the same sky time, so vs_baseline is "
                        "against the 51.8 Gb/s ADC wire budget")
    p.add_argument("--delay-ns", type=int, default=580_000,
                   help="blaster pacing for --udp, every 16 time samples "
                        "(580000 ~ 29 Gb/s at 192 channels x 704 inputs)")
    p.add_argument("--port", type=int, default=19791)
    args = p.parse_args(argv)

    stub = args.stub_device is not None
    cfg = LWA352.replace(nstand=args.nstand, nchan=args.nchan)
    if args.fx:
        if not args.udp:
            p.error("--fx requires --udp")
        cfg = cfg.replace(adc_dtype="int8")
    if args.udp and not stub:
        p.error("--udp requires --stub-device")
    if not stub and not torch.cuda.is_available():
        print("bench_pipeline: no CUDA device", file=sys.stderr)
        return 1
    device = "cpu" if stub else "cuda"

    cap = None
    if args.udp:
        from ..io import native

        cls = native.AdcCaptureSource if args.fx else native.CaptureSource
        cap = src = cls(cfg, "127.0.0.1", args.port, nbuf=16)
    else:
        src = SyntheticSource(cfg, mode="ramp", skip_write=args.skip_write,
                              target_throughput_gbps=1000.0)
    pipe = XEnginePipeline(cfg, src, stub_device_ms=args.stub_device,
                           fx_mode=args.fx, device=device)

    # whole fast windows, so the run ends on a dump
    gpa = cfg.acc_len // cfg.ntime_gulp
    est_gulps = max(int(args.seconds / (cfg.gulp_nbyte * 8 / 25.9e9)),
                    4 * gpa)
    est_gulps = (est_gulps // gpa) * gpa

    tx_threads: list[threading.Thread] = []
    data = None
    if args.udp:
        rng = np.random.RandomState(1)
        # FX wire: one snap2 "time" is one frame of 2*nchan int8 samples
        # per input (io/native.py AdcCaptureSource)
        nchan_wire = 2 * cfg.nchan if args.fx else cfg.nchan
        data = rng.randint(0, 256, [cfg.ntime_gulp, nchan_wire,
                                    cfg.ninput]).astype(np.uint8)

        def tx():
            for g in range(est_gulps + 2):
                native.transmit_gulp(
                    "127.0.0.1", args.port, data, seq0=g * cfg.ntime_gulp,
                    nchan_per_pkt=64, npol_per_pkt=cfg.ninput,
                    delay_ns=args.delay_ns)

        tx_threads.append(threading.Thread(target=tx))
    elif not stub:
        # warm-up on the card, then a second pipeline takes over the state
        pipe.run(2 * gpa, timeout_s=1800)
        src2 = SyntheticSource(cfg, mode="ramp", skip_write=args.skip_write,
                               target_throughput_gbps=1000.0)
        pipe2 = XEnginePipeline(cfg, src2, device=device)
        pipe2.state = pipe.state
        pipe = pipe2

    wire_gulp_nbyte = 2 * cfg.gulp_nbyte if args.fx else cfg.gulp_nbyte
    bar = 2 * BAR_GBPS if args.fx else BAR_GBPS

    t0 = time.perf_counter()
    for t in tx_threads:
        t.start()
    # bound the wait by the expected duration at a pessimistic 15 Gb/s and
    # report a partial run rather than hang
    expect_s = est_gulps * wire_gulp_nbyte * 8 / 15e9
    ngot = est_gulps
    partial = False
    try:
        pipe.run(est_gulps, timeout_s=max(120.0, 3 * expect_s))
    except TimeoutError:
        partial = True
        pipe.shutdown()
        if cap is not None:
            pkts_per_gulp = max(data.nbytes // (64 * cfg.ninput), 1)
            ngot = min(est_gulps, cap.stats()["npkt"] // pkts_per_gulp)
    elapsed = time.perf_counter() - t0
    for t in tx_threads:
        t.join()

    gbps = ngot * wire_gulp_nbyte * 8 / elapsed / 1e9
    perf = pipe.perf_compute
    result = {
        "metric": ("pipeline_fx_host_rate_stub_device" if args.fx
                   else "pipeline_host_rate_stub_device" if stub
                   else "pipeline_end_to_end_rate"),
        "value": gbps,
        "unit": "Gb/s",
        "vs_baseline": gbps / bar,
        "gulps": ngot,
        "partial": partial,
        "compute_thread": {
            "acquire_s": perf.acquire_time,
            "reserve_s": perf.reserve_time,
            "process_s": perf.process_time,
        },
    }
    if stub:
        result["stub_device_ms_per_window"] = args.stub_device
    if cap is not None:
        st = cap.stats()
        total = max(st["npkt"] + st["nmissing"], 1)
        result["capture"] = {"npkt": st["npkt"], "nmissing": st["nmissing"],
                             "loss_fraction": st["nmissing"] / total}
        cap.close()
    result.update(card_fields())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
