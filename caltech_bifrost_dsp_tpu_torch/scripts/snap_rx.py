"""F-engine (snap2) wire sniffer and rate validator (port of
``caltech_bifrost_dsp_tpu/scripts/snap_rx.py``).

Parity with reference: pipeline/test_receivers/snap_rx.py (header/data
dump of F-engine packets) and pipeline/test_receivers/test_eth_rx.py
(raw RX rate validation) — one tool: ``--dump`` prints decoded snap2
headers (optionally the 4+4-bit payload, sign-extended exactly as the
blocks unpack it), default mode accumulates packets/s, Gb/s, and
sequence-gap loss counters per (chan_block, pol0) source.
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

import numpy as np

from ..io import packets as pk
from ..utils import codec


def sniff(sock, npkts: int, show_data: bool = False,
          out=sys.stdout) -> int:
    """Print decoded headers (and optionally payload) for ``npkts``
    packets (snap_rx.py main loop)."""
    n = 0
    while n < npkts:
        try:
            p = sock.recv(65536)
        except socket.timeout:
            continue  # quiet wire: keep waiting (sniffer semantics)
        hdr, payload = pk.decode_snap2(p)
        print(hdr, file=out)
        if show_data:
            re, im = codec.unpack_np(payload)
            print((re[:10].astype(int) + 1j * im[:10].astype(int)),
                  file=out)
        n += 1
    return n


def rate_stats(sock, seconds: float, report_s: float = 1.0,
               out=sys.stdout) -> dict:
    """Accumulate rate and per-source loss counters for ``seconds``
    (the test_eth_rx.py job): returns
    ``{npkt, nbyte, gbps, nsrc, ngap, nooo}`` where ``ngap`` counts
    sequence numbers skipped per (chan_block, pol0) stream and
    ``nooo`` counts out-of-order/duplicate arrivals."""
    t0 = time.monotonic()
    t_report = t0 + report_s
    last_seq: dict[tuple, int] = {}
    npkt = nbyte = ngap = nooo = 0
    win_pkt = win_byte = 0
    while True:
        now = time.monotonic()
        if now >= t0 + seconds:
            break
        try:
            p = sock.recv(65536)
        except socket.timeout:
            continue
        hdr, _ = pk.decode_snap2(p)
        npkt += 1
        nbyte += len(p)
        win_pkt += 1
        win_byte += len(p)
        src = (hdr.chan_block_id, hdr.pol0)
        prev = last_seq.get(src)
        if prev is not None:
            if hdr.seq > prev:
                ngap += hdr.seq - prev - 1
            elif hdr.seq <= prev:
                nooo += 1
        last_seq[src] = max(hdr.seq, prev if prev is not None else 0)
        if now >= t_report:
            print(f"{time.ctime()}  {win_pkt/report_s:,.0f} pkt/s  "
                  f"{8*win_byte/report_s/1e9:.2f} Gb/s  "
                  f"srcs={len(last_seq)} gaps={ngap} ooo={nooo}",
                  file=out)
            win_pkt = win_byte = 0
            t_report = now + report_s
    dt = max(time.monotonic() - t0, 1e-9)
    return {"npkt": npkt, "nbyte": nbyte, "gbps": 8 * nbyte / dt / 1e9,
            "nsrc": len(last_seq), "ngap": ngap, "nooo": nooo}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="snap2 packet sniffer / "
                                            "rate validator")
    p.add_argument("--ip", type=str, default="0.0.0.0")
    p.add_argument("-P", "--port", type=int, default=10000)
    p.add_argument("--dump", action="store_true",
                   help="print decoded headers instead of rate stats")
    p.add_argument("-d", "--data", action="store_true",
                   help="with --dump: also print unpacked payload")
    p.add_argument("-n", "--npkts", type=int, default=10,
                   help="with --dump: packets to print")
    p.add_argument("-t", "--seconds", type=float, default=10.0,
                   help="stats mode: how long to listen")
    args = p.parse_args(argv)
    from ..io.sink import udp_rx_socket

    sock = udp_rx_socket(args.ip, args.port, timeout_s=0.5)
    print("Listening on %s:%d" % (args.ip, args.port))
    try:
        if args.dump:
            sniff(sock, args.npkts, show_data=args.data)
        else:
            s = rate_stats(sock, args.seconds)
            print(f"total: {s['npkt']} packets, {s['gbps']:.2f} Gb/s, "
                  f"{s['nsrc']} sources, {s['ngap']} seq gaps, "
                  f"{s['nooo']} out-of-order")
            return 1 if s["ngap"] else 0
    finally:
        sock.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
