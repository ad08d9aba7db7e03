"""Decoders of the X-engine's fast product packets, written from the wire
formats the upstream receivers read (caltech-bifrost-dsp
``corr_output_part_block.py``, ``beamform_output_block.py``,
``beamform_vlbi_output_block.py``):

- partial visibilities: big-endian u64 sync_time, u64 spectra_id, f64
  bw_hz, f64 sfreq_hz, u32 acc_len, nvis, nchans, chan0; then u32
  baselines [nvis, 2, (stand, pol)] and int32 [nvis, nchans, (re, im)];
- PBEAM: little-endian u8 server, beam, gbe, nchan, nbeam, nserver, u16
  navg, chan0, u64 seq; then f32 [nchan, nbeam, 4];
- IBEAM: little-endian u8 server, gbe, nchan, nbeam, nserver, u16 chan0,
  u64 seq; then f32 [nchan, nbeam, 2].
"""

from __future__ import annotations

import struct

import numpy as np

PART = struct.Struct(">QQddIIII")
PBEAM = struct.Struct("<BBBBBBHHQ")
IBEAM = struct.Struct("<BBBBBHQ")


def part(pkt: bytes) -> tuple[dict, np.ndarray, np.ndarray]:
    """-> (header, baselines [nvis, 2, 2], data int32 [nvis, nchans, 2])."""
    f = PART.unpack_from(pkt)
    h = dict(zip(("sync_time", "spectra_id", "bw_hz", "sfreq_hz",
                  "acc_len", "nvis", "nchans", "chan0"), f))
    off = PART.size
    nbl = h["nvis"] * 4
    bl = np.frombuffer(pkt, ">u4", nbl, off).reshape(h["nvis"], 2, 2)
    nd = h["nvis"] * h["nchans"] * 2
    if len(pkt) != off + 4 * nbl + 4 * nd:
        raise ValueError("partial-visibility packet of the wrong length")
    data = np.frombuffer(pkt, ">i4", nd, off + 4 * nbl)
    return h, bl, data.reshape(h["nvis"], h["nchans"], 2)


def pbeam(pkt: bytes) -> tuple[dict, np.ndarray]:
    """-> (header, data f32 [nchan, nbeam, 4])."""
    f = PBEAM.unpack_from(pkt)
    h = dict(zip(("server", "beam", "gbe", "nchan", "nbeam", "nserver",
                  "navg", "chan0", "seq"), f))
    n = h["nchan"] * h["nbeam"] * 4
    if len(pkt) != PBEAM.size + 4 * n:
        raise ValueError("PBEAM packet of the wrong length")
    data = np.frombuffer(pkt, "<f4", n, PBEAM.size)
    return h, data.reshape(h["nchan"], h["nbeam"], 4)


def ibeam(pkt: bytes) -> tuple[dict, np.ndarray]:
    """-> (header, data f32 [nchan, nbeam, 2])."""
    f = IBEAM.unpack_from(pkt)
    h = dict(zip(("server", "gbe", "nchan", "nbeam", "nserver", "chan0",
                  "seq"), f))
    n = h["nchan"] * h["nbeam"] * 2
    if len(pkt) != IBEAM.size + 4 * n:
        raise ValueError("IBEAM packet of the wrong length")
    data = np.frombuffer(pkt, "<f4", n, IBEAM.size)
    return h, data.reshape(h["nchan"], h["nbeam"], 2)
