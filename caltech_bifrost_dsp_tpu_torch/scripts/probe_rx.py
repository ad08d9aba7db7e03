"""Packet loss of the COR receiver (``scripts/corr_rx.py``) at a pace, over
loopback, with and without other processes busy on the host's cores.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.probe_rx \\
        [--paces 100 250 -1] [--repeats 3] [--burners 0 6] [-s 352] [-c 192]

Encodes one full integration of random int32 planes with the port's COR
sink (``io/sink.py::CorrFullOutput``, ``use_cor_fmt``), then, for each
pace (Mb/s through the sinks' ``Throttle``; -1 sends unpaced), each count
of busy-loop processes and each repeat, starts a receiver process
(``receive_matrix_cor`` on a socket set up as the CLI sets it up, a 5 s
timeout) and sends it the stream.  A run is lost when the receiver times
out short of the last baseline.  Prints one line a run (packets received,
send time, the receive buffer the host granted) and one JSON line.  Runs
on the host alone; no card is needed.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import re
import socket
import sys
import time

import numpy as np

from ..config import LWA352
from ..io import sink
from . import corr_rx


def receive(conn, nstand: int, nchan: int) -> None:
    """In a process of its own: the CLI's socket, one integration."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 64 * 1024 * 1024)
    sock.bind(("127.0.0.1", 0))
    conn.send((sock.getsockname()[1],
               sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)))
    n_bl = nstand * (nstand + 1) // 2
    try:
        corr_rx.receive_matrix_cor(sock, nstand, 2, nchan, timeout_s=5.0)
        conn.send(n_bl)
    except TimeoutError as err:
        conn.send(int(re.search(r"with (\d+) of", str(err)).group(1)))


def burn() -> None:
    while True:
        pass


def cor_stream(nstand: int, nchan: int, seed: int = 0) -> list:
    cfg = LWA352.replace(nstand=nstand, nchan=nchan)
    rng = np.random.RandomState(seed)
    shape = (cfg.nchan, cfg.ninput, cfg.ninput)
    re_, im = (rng.randint(-2**20, 2**20, shape, dtype=np.int32)
               for _ in range(2))
    pkts = []
    sink.CorrFullOutput(cfg, send=pkts.append, use_cor_fmt=True) \
        .send_matrix_planes(re_, im, 1_700_000_000, 4800, cfg.acc_len)
    return pkts


def run(pkts: list, nstand: int, nchan: int, mbps: float,
        burners: int) -> dict:
    ctx = mp.get_context("fork")
    busy = [ctx.Process(target=burn, daemon=True) for _ in range(burners)]
    for p in busy:
        p.start()
    here, there = ctx.Pipe()
    rx = ctx.Process(target=receive, args=(there, nstand, nchan))
    rx.start()
    try:
        port, rcvbuf = here.recv()
        throttle = sink.Throttle(mbps * 1e6 if mbps > 0 else None)
        send = sink.UdpSender("127.0.0.1", port)
        t0 = time.perf_counter()
        for pkt in pkts:
            send(pkt)
            throttle.account(8 * len(pkt))
        send_s = time.perf_counter() - t0
        got = here.recv()
    finally:
        rx.join(30)
        for p in busy:
            p.kill()
            p.join()
    nbyte = sum(map(len, pkts))
    return {"pace_mbps": mbps, "burners": burners, "packets": len(pkts),
            "received": got, "lost": len(pkts) - got, "send_s": send_s,
            "sent_mbps": 8 * nbyte / send_s / 1e6, "rcvbuf": rcvbuf}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--paces", type=float, nargs="+", default=[100, 250])
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--burners", type=int, nargs="+", default=[0, 6])
    p.add_argument("-s", "--nstand", type=int, default=LWA352.nstand)
    p.add_argument("-c", "--nchan", type=int, default=LWA352.nchan)
    args = p.parse_args(argv)
    pkts = cor_stream(args.nstand, args.nchan)
    print(f"{len(pkts)} COR packets of {len(pkts[0])} B "
          f"({args.nstand} stands x {args.nchan} channels)", flush=True)
    runs = []
    for mbps in args.paces:
        for burners in args.burners:
            for _ in range(args.repeats):
                r = run(pkts, args.nstand, args.nchan, mbps, burners)
                runs.append(r)
                print(f"pace {mbps:g} Mb/s, {burners} busy processes: "
                      f"{r['received']} of {r['packets']} received, sent in "
                      f"{r['send_s']:.2f} s ({r['sent_mbps']:.0f} Mb/s), "
                      f"receive buffer {r['rcvbuf']} B", flush=True)
    print(json.dumps({"probe_rx": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
