"""Subselected ("partial") correlation packet receiver + golden checker
(port of ``caltech_bifrost_dsp_tpu/scripts/corr_part_rx.py``).

Parity with reference: pipeline/test_receivers/corr_part_rx.py —
listens for partial-correlation UDP packets (CorrPartHeader wire
format, io/packets.py), skips the in-flight integration, reassembles
the next complete one in arrival order, and writes a reference-format
``.dat`` file (one-line JSON header + complex128 payload).

The ``--goldfile`` mode is the verification gate of
reference: pipeline/verification/test_corr_part_rx.py — it integrates
a golden correlation file up to the received accumulation (channel
summing by ``gold_nchan // uut_nchan`` and gold-file repetition
arithmetic for long accumulations) and requires EXACT integer
equality per baseline.
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
from ..verification import golden


def receive_part(sock, nbl: int, nchan: int, nvis_per_packet: int = 16,
                 timeout_s: float = 30.0, skip_first: bool = True):
    """Collect one complete subselection integration.

    Mirrors the reference receiver's protocol
    (corr_part_rx.py:89-116): note the spectra_id of the first packet
    seen, spin until it changes (dropping the partial in-flight
    integration), then fill baselines in arrival order.  Returns
    ``(hdr, baselines int32 [nbl, 2, 2], outbuf complex128
    [nbl, nchan])``.
    """
    sock.settimeout(timeout_s)
    outbuf = np.zeros([nbl, nchan], np.complex128)
    outbls = np.zeros([nbl, 2, 2], np.int32)
    target_id = None
    first_id = None
    blcnt = 0
    hdr = None
    while blcnt < nbl:
        hdr, bls, data = pk.decode_corr_part(sock.recv(65536))
        if skip_first:
            if first_id is None:
                first_id = hdr.spectra_id
            if hdr.spectra_id == first_id:
                continue
        if target_id is None:
            target_id = hdr.spectra_id
        elif hdr.spectra_id != target_id:
            raise RuntimeError(
                "spectra ID mismatch mid-integration: %d != %d"
                % (hdr.spectra_id, target_id))
        # the expected count need not be a packet multiple: trim the
        # final packet instead of crashing on the slice assignment
        n = min(hdr.nvis, nbl - blcnt)
        outbls[blcnt:blcnt + n] = bls[:n]
        outbuf[blcnt:blcnt + n] = (data[:n, :, 0] + 1j * data[:n, :, 1])
        blcnt += n
    return hdr, outbls, outbuf


def write_rx_file(path_dir: str, hdr, baselines: np.ndarray,
                  outbuf: np.ndarray, nvis_per_packet: int = 16) -> str:
    """Reference-format output file (corr_part_rx.py:115-142):
    ``test_corr_part_rx_<t0>t_<chan0>c_<nchans>nc_<acc>a.dat``."""
    nbl, nchan = outbuf.shape
    meta = {
        "ntime": 1,
        "time": time.time(),
        "nchan": nchan,
        "chan0": hdr.chan0,
        "acc_len": hdr.acc_len,
        "t0": hdr.spectra_id,
        "type": "corr_part_rx",
        "shape": list(outbuf.shape),
        "dtype": str(outbuf.dtype),
        "nbl": nbl,
        "nblpkt": nvis_per_packet,
        "baselines": baselines.tolist(),
    }
    fname = os.path.join(
        path_dir, "test_corr_part_rx_%dt_%dc_%dnc_%da.dat"
        % (hdr.spectra_id, hdr.chan0, nchan, hdr.acc_len))
    with open(fname, "wb") as fh:
        fh.write(json.dumps(meta).encode())
        fh.write(b"\n")
        fh.write(outbuf.tobytes())
    return fname


def check_against_golden(goldfile: str, uutfile: str,
                         verbose: bool = False) -> tuple[int, int]:
    """Exact-equality check of a received subselection integration
    against a golden correlation file (the arithmetic of
    reference: verification/test_corr_part_rx.py:38-86).  Returns
    ``(n_ok, n_err)`` over baselines."""
    gold_meta, gold = golden.read_dat(goldfile)
    with open(uutfile, "rb") as fh:
        uut_meta = json.loads(fh.readline().decode())
        uut = np.frombuffer(fh.read(), np.complex128).reshape(
            uut_meta["shape"])

    # Sum golden channels down to the subselection's averaged grid.
    gold_nchan, uut_nchan = gold_meta["nchan"], uut_meta["nchan"]
    if gold_nchan % uut_nchan:
        raise ValueError("gold nchan %d not a multiple of uut nchan %d"
                         % (gold_nchan, uut_nchan))
    chan_sum = gold_nchan // uut_nchan
    gs = list(gold.shape)
    gold = gold.reshape([gs[0], gs[1] // chan_sum, chan_sum] + gs[2:]
                        ).sum(axis=2)

    # Integrate the (cyclic) golden file up to the UUT accumulation.
    g_acc, g_ntime = gold_meta["acc_len"], gold_meta["ntime"]
    u_acc, u_t0 = uut_meta["acc_len"], uut_meta["t0"]
    if (u_acc % g_acc) or (u_t0 % g_acc):
        raise ValueError("uut acc_len/t0 not aligned to gold acc_len")
    repeats = u_acc // (g_acc * g_ntime)
    extra = (u_acc // g_acc) % g_ntime
    start = (u_t0 // g_acc) % g_ntime
    acc = gold.sum(axis=0) * repeats
    for t in range(start, start + extra):
        acc = acc + gold[t % g_ntime]

    n_ok = n_err = 0
    for bln, ((s0, p0), (s1, p1)) in enumerate(uut_meta["baselines"]):
        if np.array_equal(acc[:, s0, s1, p0, p1], uut[bln]):
            n_ok += 1
        else:
            n_err += 1
            if verbose:
                print("Error! s0: %d, p0: %d, s1: %d, p1: %d"
                      % (s0, p0, s1, p1))
    return n_ok, n_err


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Partial-correlation (subselection) packet receiver")
    p.add_argument("--ip", type=str, default="0.0.0.0")
    p.add_argument("-P", "--port", type=int, default=11112)
    p.add_argument("-f", "--outpath", type=str, default=".")
    p.add_argument("-c", "--nchan", type=int, default=48,
                   help="channels expected (post channel-averaging)")
    p.add_argument("-b", "--nbl", type=int, default=4704,
                   help="baselines expected")
    p.add_argument("-p", "--nblpkt", type=int, default=16,
                   help="baselines per packet")
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("-i", "--goldfile", type=str, default=None,
                   help="golden corr .dat: verify the received "
                        "integration exactly and exit nonzero on error")
    args = p.parse_args(argv)

    from ..io.sink import udp_rx_socket

    sock = udp_rx_socket(args.ip, args.port)
    print("Listening on %s:%d (%d baselines x %d chans)"
          % (args.ip, args.port, args.nbl, args.nchan))
    hdr, bls, outbuf = receive_part(sock, args.nbl, args.nchan,
                                    args.nblpkt, timeout_s=args.timeout)
    sock.close()
    fname = write_rx_file(args.outpath, hdr, bls, outbuf, args.nblpkt)
    print("wrote", fname)
    if args.goldfile:
        n_ok, n_err = check_against_golden(args.goldfile, fname,
                                           verbose=True)
        print("%d baselines ok, %d errors" % (n_ok, n_err))
        return 1 if n_err else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
