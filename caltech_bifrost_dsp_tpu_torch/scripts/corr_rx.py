"""Full-correlation packet receiver (port of
``caltech_bifrost_dsp_tpu/scripts/corr_rx.py``).

Parity with reference: pipeline/test_receivers/corr_full_rx.py — listens
for full-correlation UDP packets, reassembles the complete Hermitian
visibility cube (conjugating the mirrored triangle exactly as the
reference receiver does, corr_full_rx.py:94-99) and writes a
reference-format ``.dat`` file with a one-line JSON header.
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


def recv(sock, got: int, n_bl: int) -> bytes:
    """One datagram; a timeout says how far the integration had come."""
    try:
        return sock.recv(65536)
    except TimeoutError:
        raise TimeoutError(f"timed out with {got} of {n_bl} baselines of "
                           "the integration received") from None


def as_complex(payload: np.ndarray) -> np.ndarray:
    """complex128 copy of a packet's (re, im) int32 pairs on the last axis.

    One packet is written into the cube as two whole blocks, the direct
    baseline and then (after :func:`conjugate`) its mirror, rather than
    one channel vector per polarization pair: a quarter of the time a
    packet, so that the loop keeps up with a paced stream.  The cube is
    the per-pair loop's byte for byte, autos included, since the mirror is
    written last as that loop leaves it."""
    return payload.astype(np.float64).view(np.complex128)[..., 0]


def conjugate(vis: np.ndarray) -> None:
    """``vis`` to ``re - 1j*im`` in place; the imaginary part is
    ``0.0 - im``, a +0.0 where ``im`` is 0 as ``re - 1j*im`` gives."""
    np.subtract(0.0, vis.imag, out=vis.imag)


def receive_matrix(sock, nstand: int, npol: int, nchan: int,
                   timeout_s: float = 30.0):
    """Collect one full integration; returns (header, outbuf) where
    outbuf is complex128 [nstand, nstand, npol, npol, nchan]."""
    n_bl = nstand * (nstand + 1) // 2
    outbuf = np.zeros([nstand, nstand, npol, npol, nchan], np.complex128)
    sock.settimeout(timeout_s)
    spectra_id = None
    got = 0
    last_hdr = None
    while got < n_bl:
        pkt = recv(sock, got, n_bl)
        hdr, payload = pk.decode_corr_full(pkt)
        if spectra_id is None:
            spectra_id = hdr.spectra_id
        elif hdr.spectra_id != spectra_id:
            continue  # a different integration; keep filling this one
        last_hdr = hdr
        n = hdr.npols
        vis = as_complex(payload)                       # [p0, p1, chan]
        outbuf[hdr.stand0, hdr.stand1, :n, :n] = vis
        conjugate(vis)
        outbuf[hdr.stand1, hdr.stand0, :n, :n] = vis.transpose(1, 0, 2)
        got += 1
    return last_hdr, outbuf


def receive_matrix_cor(sock, nstand: int, npol: int, nchan: int,
                       timeout_s: float = 30.0):
    """COR (Mark5C) variant — parity with
    reference: test_receivers/corr_full_rx_bifrost_packets.py:96-103.
    Returns (CorHeader, complex128 [nstand, nstand, npol, npol, nchan])."""
    n_bl = nstand * (nstand + 1) // 2
    outbuf = np.zeros([nstand, nstand, npol, npol, nchan], np.complex128)
    sock.settimeout(timeout_s)
    time_tag = None
    got = 0
    last_hdr = None
    while got < n_bl:
        pkt = recv(sock, got, n_bl)
        hdr, payload = pk.decode_cor(pkt, npol)
        if time_tag is None:
            time_tag = hdr.time_tag
        elif hdr.time_tag != time_tag:
            continue
        last_hdr = hdr
        i, j = hdr.stand_i - 1, hdr.stand_j - 1
        vis = as_complex(payload)                       # [chan, p0, p1]
        outbuf[i, j] = vis.transpose(1, 2, 0)
        conjugate(vis)
        outbuf[j, i] = vis.transpose(2, 1, 0)
        got += 1
    return last_hdr, outbuf


def write_rx_file(path_dir, hdr, outbuf, nstand, npol):
    """Reference output naming + format (corr_full_rx.py:103-130)."""
    fname = os.path.join(
        path_dir, "test_corr_full_rx_%dt_%dc_%dnc_%da.dat"
        % (hdr.spectra_id, hdr.chan0, hdr.nchans, hdr.acc_len))
    meta = {"ntime": 1, "time": time.time(), "nchan": hdr.nchans,
            "chan0": hdr.chan0, "acc_len": hdr.acc_len,
            "t0": hdr.spectra_id, "type": "corr_full_rx",
            "shape": list(outbuf.shape), "dtype": str(outbuf.dtype),
            "nstand": nstand, "npol": npol}
    with open(fname, "wb") as fh:
        fh.write(json.dumps(meta).encode())
        fh.write(b"\n")
        fh.write(outbuf.tobytes())
    return fname


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="COR packet receiver")
    p.add_argument("--ip", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=10001)
    p.add_argument("-s", "--nstand", type=int, default=352)
    p.add_argument("-p", "--npol", type=int, default=2)
    p.add_argument("-c", "--nchan", type=int, default=192)
    p.add_argument("--outpath", type=str, default=".")
    p.add_argument("--cor-fmt", action="store_true",
                   help="decode LWA-SV COR (Mark5C) packets instead of "
                        "the custom 56-byte format")
    args = p.parse_args(argv)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 64 * 1024 * 1024)
    sock.bind((args.ip, args.port))
    rx = receive_matrix_cor if args.cor_fmt else receive_matrix
    hdr, outbuf = rx(sock, args.nstand, args.npol, args.nchan)
    if args.cor_fmt:
        # adapt the Mark5C header to the .dat naming fields
        hdr = pk.CorrFullHeader(
            sync_time=0, spectra_id=hdr.time_tag, bw_hz=0.0, sfreq_hz=0.0,
            acc_len=hdr.cor_navg, nchans=args.nchan,
            chan0=hdr.freq_count, npols=args.npol, stand0=0, stand1=0)
    fname = write_rx_file(args.outpath, hdr, outbuf, args.nstand,
                          args.npol)
    print("wrote", fname)
    return 0


if __name__ == "__main__":
    sys.exit(main())
