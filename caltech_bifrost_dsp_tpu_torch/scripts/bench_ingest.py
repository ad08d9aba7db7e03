"""Ingest bench: sustained capture -> gulp assembly at the production
operating point, against the reference's real-time bar (port of
``caltech_bifrost_dsp_tpu/scripts/bench_ingest.py``).

    python -m caltech_bifrost_dsp_tpu_torch.scripts.bench_ingest \\
        [--ngulp N] [--engines E] [--delay-ns D] [--h2d] [--adc]

The reference sustains 25.9 Gb/s per pipeline with IB-Verbs kernel
bypass, and a production server runs four capture pipelines
(capture_block.py:180-189, lwa352_xeng_etcd_client.py:16-26).  This bench
drives ``--engines`` native capture engines of the port's
(``io/native.py::NativeCapture``, one RX thread and one UDP port each) with
as many native paced blasters (``native.transmit_stream``) over loopback,
and reports the aggregate rate through full gulp reassembly, with the
loss.  Each blaster burns a core, so on a host of shared cores the core
count bounds the fan-out; the JSON reports it.

``--h2d`` extends the path with an upload of every gulp to the card: a copy
into a pinned buffer kept across gulps, ``.to("cuda", non_blocking=True)``
and a stream synchronize, the capture -> device feeding path.  Only it
needs a CUDA device, and without one it exits non-zero.  ``--adc`` takes
the FX wire geometry (int8 ADC frames: 2 * nchan bytes a frame).

Prints one JSON line with the JAX script's keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``engines``, ``host_cores``, ``gulps``,
``loss_fraction``) and the card's ``device`` and ``power_limit`` (None on
a host without one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from ..config import XEngineConfig
from ..io import native
from ..utils.roofline import card_fields


def run_engines(cfg, ports, data, ngulp: int, delay_ns: int,
                dev_put=None, consume_timeout_s: float = 3.0) -> dict:
    """One capture + blaster + consumer per port; the aggregate stats.
    Loss-free means ``nmissing == 0`` over every engine."""
    caps = [native.NativeCapture(cfg, "127.0.0.1", p, nbuf=16)
            for p in ports]
    for c in caps:
        c.start()
    got = [0] * len(ports)
    tx_secs = [0.0] * len(ports)
    tx_npkt = [0] * len(ports)

    def tx(k, port):
        # one native call for the whole stream: one socket and one absolute
        # pacing deadline; its time tells a pacing slip (a starved sender)
        # from a capture stall
        t0 = time.perf_counter()
        tx_npkt[k] = native.transmit_stream(
            "127.0.0.1", port, data, ngulp, nchan_per_pkt=64,
            npol_per_pkt=cfg.ninput, delay_ns=delay_ns)
        tx_secs[k] = time.perf_counter() - t0

    def consume(i):
        while got[i] < ngulp:
            seq0, gulp = caps[i].get_gulp(timeout_s=consume_timeout_s)
            if seq0 is None:
                break
            if dev_put is not None:
                dev_put(gulp)
            got[i] += 1

    t0 = time.perf_counter()
    threads = ([threading.Thread(target=tx, args=(k, p))
                for k, p in enumerate(ports)]
               + [threading.Thread(target=consume, args=(i,))
                  for i in range(len(ports))])
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0

    stats = [c.stats() for c in caps]
    for c in caps:
        c.close()
    # the rate the blasters delivered, payload bytes only (as captured)
    payload = 64 * cfg.ninput
    tx_gbps = sum(8 * n * payload / max(s, 1e-9) / 1e9
                  for n, s in zip(tx_npkt, tx_secs))
    return {"dt": dt, "ngot": sum(got),
            "nmissing": sum(s["nmissing"] for s in stats),
            "npkt": sum(s["npkt"] for s in stats),
            "per_engine_gulps": got, "tx_gbps": tx_gbps}


def h2d_put(nbyte: int, dev):
    """A ``dev_put`` that uploads each gulp through one pinned buffer."""
    pinned = torch.empty(nbyte, dtype=torch.uint8, pin_memory=True)
    stream = torch.cuda.Stream(dev)

    def put(gulp: np.ndarray) -> None:
        pinned.copy_(torch.from_numpy(gulp.reshape(-1)))
        with torch.cuda.stream(stream):
            pinned.to(dev, non_blocking=True)
        stream.synchronize()

    return put


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ingest benchmark")
    p.add_argument("--ngulp", type=int, default=100)
    p.add_argument("--engines", type=int, default=1,
                   help="parallel capture engines (one port + RX thread "
                        "each; the reference runs 4 per server)")
    p.add_argument("--delay-ns", type=int, default=580_000,
                   help="TX pacing per engine, every 16 time samples; "
                        "668000 offers ~25.9 Gb/s (the reference real-time "
                        "bar) at the production packet geometry")
    p.add_argument("--port", type=int, default=19757)
    p.add_argument("--h2d", action="store_true",
                   help="also upload each gulp to the card (pinned buffer, "
                        "non-blocking copy, stream synchronize)")
    p.add_argument("--adc", action="store_true",
                   help="FX-mode wire geometry: int8 ADC frames (nchan -> "
                        "2*nchan bytes) instead of packed 4+4-bit voltages")
    args = p.parse_args(argv)
    if args.h2d and not torch.cuda.is_available():
        print("bench_ingest: no CUDA device", file=sys.stderr)
        return 1

    cfg = XEngineConfig(nstand=352, nchan=192, ntime_gulp=480)
    if args.adc:
        # the engine reassembles bytes of any geometry: ADC mode is the same
        # engine with 2*nchan byte "channels" a frame
        cfg = cfg.replace(nchan=2 * cfg.nchan)
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, [cfg.ntime_gulp, cfg.nchan, cfg.ninput]) \
        .astype(np.uint8)

    dev_put = (h2d_put(data.nbytes, torch.device("cuda:0")) if args.h2d
               else None)

    ports = [args.port + i for i in range(args.engines)]
    r = run_engines(cfg, ports, data, args.ngulp, args.delay_ns, dev_put)

    total_pkts = max(r["npkt"] + r["nmissing"], 1)
    gbps = 8 * r["ngot"] * data.nbytes / r["dt"] / 1e9
    print(json.dumps({
        "metric": ("ingest_adc_rate" if args.adc else
                   "ingest_h2d_rate" if args.h2d else
                   "ingest_sustained_rate"),
        "value": gbps,
        "unit": "Gb/s",
        "vs_baseline": gbps / 25.9,
        "engines": args.engines,
        "host_cores": os.cpu_count(),
        "gulps": r["ngot"],
        "loss_fraction": r["nmissing"] / total_pkts,
        "tx_gbps": r["tx_gbps"],
        **card_fields()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
