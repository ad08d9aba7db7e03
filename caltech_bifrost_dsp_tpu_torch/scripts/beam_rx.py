"""Power-beam (PBEAM) packet receiver (port of
``caltech_bifrost_dsp_tpu/scripts/beam_rx.py``).

Parity with reference: pipeline/test_receivers/beam_rx_power_bifrost_packets.py
— listens for PBEAM packets (18-byte big-endian header + f32 payload,
io/packets.py), keeps per-server packet counters, prints
non-zero-power dump lines with the sequence/dump deltas the reference
prints, and (beyond the reference, which only prints) can capture a
fixed number of integrations per beam to a reference-style ``.dat``
file for offline checking.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np

from ..io import packets as pk


def receive_powers(sock, nbeam: int, nseq: int, nchan: int,
                   timeout_s: float = 30.0):
    """Collect ``nseq`` consecutive integrations for ``nbeam`` beams.

    Beams are keyed by the 1-based ``beam`` header field.  Returns
    ``(hdr, seqs, powers f32 [nseq, nbeam, nchan, 4])`` where ``seqs``
    is the sorted list of sequence stamps kept (the first ``nseq``
    common to every beam).
    """
    sock.settimeout(timeout_s)
    per_beam: dict[int, dict[int, np.ndarray]] = {}
    hdr = None
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        hdr, payload = pk.decode_pbeam(sock.recv(65536))
        if payload.shape[0] != nchan:
            raise RuntimeError("nchan mismatch: packet %d != expected %d"
                               % (payload.shape[0], nchan))
        # payload is [nchan, nbeam_pkt, 4]; nbeam_pkt is 1 on this wire
        per_beam.setdefault(hdr.beam, {})[hdr.seq] = payload[:, 0, :]
        if len(per_beam) >= nbeam:
            common = set.intersection(
                *(set(d.keys()) for d in per_beam.values()))
            if len(common) >= nseq:
                break
    else:
        raise TimeoutError("timed out collecting %d seqs x %d beams"
                           % (nseq, nbeam))
    seqs = sorted(common)[:nseq]
    beams = sorted(per_beam.keys())[:nbeam]
    out = np.zeros([nseq, nbeam, nchan, 4], np.float32)
    for si, s in enumerate(seqs):
        for bi, b in enumerate(beams):
            out[si, bi] = per_beam[b][s]
    return hdr, seqs, out


def write_rx_file(path_dir: str, hdr, seqs, powers: np.ndarray) -> str:
    """One-line JSON header + raw f32 payload, reference ``.dat``
    conventions (shape [nseq, nbeam, nchan, 4])."""
    meta = {
        "type": "beam_rx_power",
        "time": time.time(),
        "nchan": int(powers.shape[2]),
        "chan0": hdr.chan0,
        "navg": hdr.navg,
        "nbeam": int(powers.shape[1]),
        "seq0": int(seqs[0]),
        "seqs": [int(s) for s in seqs],
        "shape": list(powers.shape),
        "dtype": "float32",
    }
    fname = os.path.join(path_dir, "test_beam_rx_%dt_%dc_%da.dat"
                         % (seqs[0], hdr.chan0, hdr.navg))
    with open(fname, "wb") as fh:
        fh.write(json.dumps(meta).encode())
        fh.write(b"\n")
        fh.write(np.ascontiguousarray(powers, np.float32).tobytes())
    return fname


def stats_loop(sock, npkts: int | None, interval: int = 100000,
               stats_only: bool = False, timeout_s: float = 30.0) -> list:
    """The reference receiver's main loop
    (beam_rx_power_bifrost_packets.py:72-90): per-server packet
    counters printed every ``interval`` packets; in non-stats mode,
    print a line for each non-zero power dump with the seq/dump
    deltas."""
    sock.settimeout(timeout_s)
    packets_per_server: list[int] = []
    packet_cnt = 0
    last_seq = 0
    while npkts is None or packet_cnt < npkts:
        hdr, payload = pk.decode_pbeam(sock.recv(65536))
        packet_cnt += 1
        if not packets_per_server:
            packets_per_server = [0] * hdr.nserver
        # server is 1-based on the wire; don't trust it: server=0 would
        # silently increment index -1 and server>nserver would raise and
        # kill the monitoring loop on one malformed packet
        if 1 <= hdr.server <= len(packets_per_server):
            packets_per_server[hdr.server - 1] += 1
        if packet_cnt % interval == 0:
            print(time.ctime(), "packets_per_server:", packets_per_server)
        if stats_only:
            continue
        if np.any(payload):
            seqdelta = hdr.seq - last_seq
            print(hdr, packet_cnt, seqdelta, seqdelta / hdr.navg)
            last_seq = hdr.seq
    return packets_per_server


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="PBEAM packet receiver")
    p.add_argument("--ip", type=str, default="0.0.0.0")
    p.add_argument("-P", "--port", type=int, default=11111)
    p.add_argument("--stats-only", action="store_true",
                   help="just count packets per server")
    p.add_argument("--npkts", type=int, default=None,
                   help="stop after this many packets (stats modes)")
    p.add_argument("--capture", action="store_true",
                   help="capture --nseq integrations per beam to a .dat")
    p.add_argument("--nbeam", type=int, default=1)
    p.add_argument("--nseq", type=int, default=4)
    p.add_argument("-c", "--nchan", type=int, default=48)
    p.add_argument("-f", "--outpath", type=str, default=".")
    p.add_argument("--timeout", type=float, default=30.0)
    args = p.parse_args(argv)

    from ..io.sink import udp_rx_socket

    sock = udp_rx_socket(args.ip, args.port)
    print("Listening on %s:%d" % (args.ip, args.port))
    try:
        if args.capture:
            hdr, seqs, powers = receive_powers(
                sock, args.nbeam, args.nseq, args.nchan,
                timeout_s=args.timeout)
            fname = write_rx_file(args.outpath, hdr, seqs, powers)
            print("wrote", fname)
        else:
            stats_loop(sock, args.npkts, stats_only=args.stats_only,
                       timeout_s=args.timeout)
    finally:
        sock.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
