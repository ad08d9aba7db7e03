"""Wire formats (port of ``caltech_bifrost_dsp_tpu/io/packets.py``): snap2
input packets and the COR / partial-corr / PBEAM / IBEAM product packets.

Every encoder produces the JAX package's bytes:

- snap2 F-engine packets: little-endian C struct
  (reference: test_transmitters/test_tx_mt.c:38-49) + uint8 [nchan, npol]
  packed 4+4-bit payload.
- Full-correlation packets: 56-byte big-endian header + int32
  [npol, npol, nchan, 2] payload (corr_output_full_block.py:446-479).
- LWA-SV "COR" (Mark5C) packets, the production output format: 32-byte
  big-endian header + int32 [nchan, npol, npol, 2] payload
  (corr_full_rx_bifrost_packets.py:28-42).
- Partial (fast) correlation packets: big-endian header carrying the
  baseline list, then int32 [nvis, nchan, 2].
- PBEAM power-beam packets: 18-byte header + f32 [nchan, nbeam, 4].
- IBEAM voltage-beam packets: 15-byte header + f32 [nchan, nbeam, 2].
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

SNAP2_MAGIC = 0xAABBCCDD

# uint64 seq, uint32 magic, 4x uint16, 3x uint32 (host order as transmitted)
_SNAP2_HDR = struct.Struct("<QIHHHHIII")

_COR_FULL_HDR = struct.Struct(">QQ2d4I2I")       # 56 bytes
_COR_PART_HDR = struct.Struct(">QQ2d4I")         # + baselines + payload
_PBEAM_HDR = struct.Struct("<BBBBBBHHQ")         # 18 bytes
_IBEAM_HDR = struct.Struct("<BBBBBHQ")           # 15 bytes


# ---------------------------------------------------------------------------
# snap2 (F-engine -> X-engine input)
# ---------------------------------------------------------------------------

@dataclass
class Snap2Header:
    seq: int
    npol: int
    npol_tot: int
    nchan: int
    nchan_tot: int
    chan_block_id: int
    chan0: int
    pol0: int


def encode_snap2(hdr: Snap2Header, payload: np.ndarray) -> bytes:
    """payload: uint8 [nchan, npol] packed 4+4-bit."""
    if payload.shape != (hdr.nchan, hdr.npol):
        raise ValueError("payload shape mismatch")
    return _SNAP2_HDR.pack(hdr.seq, SNAP2_MAGIC, hdr.npol, hdr.npol_tot,
                           hdr.nchan, hdr.nchan_tot, hdr.chan_block_id,
                           hdr.chan0, hdr.pol0) + \
        np.ascontiguousarray(payload, dtype=np.uint8).tobytes()


def decode_snap2(pkt: bytes) -> tuple[Snap2Header, np.ndarray]:
    (seq, magic, npol, npol_tot, nchan, nchan_tot, chan_block_id, chan0,
     pol0) = _SNAP2_HDR.unpack_from(pkt)
    if magic != SNAP2_MAGIC:
        raise ValueError(f"bad snap2 magic {magic:#x}")
    payload = np.frombuffer(pkt, dtype=np.uint8,
                            offset=_SNAP2_HDR.size).reshape(nchan, npol)
    return (Snap2Header(seq, npol, npol_tot, nchan, nchan_tot,
                        chan_block_id, chan0, pol0), payload)


def snap2_packets_for_gulp(packed: np.ndarray, seq0: int, chan0: int,
                           nchan_tot: int, npol_tot: int,
                           npol_per_pkt: int = 64,
                           nchan_per_pkt: int | None = None):
    """Packetize a [ntime, nchan, ninput] gulp into snap2 packets, one per
    (time, chan block, pol block), in the F-engine's emission order."""
    ntime, nchan, ninput = packed.shape
    nchan_per_pkt = nchan_per_pkt or nchan
    for t in range(ntime):
        for cb in range(nchan // nchan_per_pkt):
            for pb in range(ninput // npol_per_pkt):
                payload = packed[t,
                                 cb * nchan_per_pkt:(cb + 1) * nchan_per_pkt,
                                 pb * npol_per_pkt:(pb + 1) * npol_per_pkt]
                hdr = Snap2Header(seq=seq0 + t, npol=npol_per_pkt,
                                  npol_tot=npol_tot, nchan=nchan_per_pkt,
                                  nchan_tot=nchan_tot, chan_block_id=cb,
                                  chan0=chan0 + cb * nchan_per_pkt,
                                  pol0=pb * npol_per_pkt)
                yield encode_snap2(hdr, payload)


# ---------------------------------------------------------------------------
# Full-correlation packets (custom format)
# ---------------------------------------------------------------------------

@dataclass
class CorrFullHeader:
    sync_time: int
    spectra_id: int
    bw_hz: float
    sfreq_hz: float
    acc_len: int
    nchans: int
    chan0: int
    npols: int
    stand0: int
    stand1: int


def encode_corr_full(hdr: CorrFullHeader, data: np.ndarray) -> bytes:
    """data: int32 [npols, npols, nchans, 2] for one dual-pol baseline."""
    if data.shape != (hdr.npols, hdr.npols, hdr.nchans, 2):
        raise ValueError("payload shape mismatch")
    return _COR_FULL_HDR.pack(hdr.sync_time, hdr.spectra_id, hdr.bw_hz,
                              hdr.sfreq_hz, hdr.acc_len, hdr.nchans,
                              hdr.chan0, hdr.npols, hdr.stand0,
                              hdr.stand1) + \
        np.ascontiguousarray(data, dtype=">i4").tobytes()


def decode_corr_full(pkt: bytes) -> tuple[CorrFullHeader, np.ndarray]:
    hdr = CorrFullHeader(*_COR_FULL_HDR.unpack_from(pkt))
    data = np.frombuffer(pkt, dtype=">i4", offset=_COR_FULL_HDR.size)
    return hdr, data.reshape(hdr.npols, hdr.npols, hdr.nchans, 2)


# ---------------------------------------------------------------------------
# LWA-SV "COR" (Mark5C) packets, the production output format
# ---------------------------------------------------------------------------

COR_SYNC_WORD = 0xDEC0DE5C   # Mark 5C magic
COR_ID = 0x02                # Mark 5C packet-type ID for COR

# sync_word, id<<24|frame_number, secs_count, freq_count, cor_gain,
# time_tag, cor_navg, stand_i, stand_j  (32 bytes, network order)
_COR5C_HDR = struct.Struct(">IIIHHQIHH")


def cor_frame_number(nchan_sum: int, npipeline: int,
                     pipeline_idx: int) -> int:
    """24-bit COR frame number: channel-decimation factor, total subbands
    and 1-indexed subband (corr_output_full_block.py:378-381)."""
    wrapped_idx = ((pipeline_idx - 1) % npipeline) + 1
    return ((nchan_sum << 16) | (npipeline << 8) | wrapped_idx) & 0xFFFFFF


@dataclass
class CorHeader:
    frame_number: int   # 24-bit subband encoding (see cor_frame_number)
    secs_count: int     # Mark 5C seconds count
    freq_count: int     # zero-indexed first F-engine channel in packet
    cor_gain: int       # right bitshift gain compensation (0)
    time_tag: int       # central sampling time, ADC sample units
    cor_navg: int       # integration time, ADC sample units
    stand_i: int        # 1-indexed unconjugated stand
    stand_j: int        # 1-indexed conjugated stand


def encode_cor(hdr: CorHeader, data: np.ndarray) -> bytes:
    """data: int32 [nchan, npol, npol, 2] (chan-major) for one dual-pol
    baseline."""
    if data.ndim != 4 or data.shape[3] != 2:
        raise ValueError("payload must be [nchan, npol, npol, 2]")
    return _COR5C_HDR.pack(
        COR_SYNC_WORD, (COR_ID << 24) | (hdr.frame_number & 0xFFFFFF),
        hdr.secs_count, hdr.freq_count, hdr.cor_gain, hdr.time_tag,
        hdr.cor_navg, hdr.stand_i, hdr.stand_j) + \
        np.ascontiguousarray(data, dtype=">i4").tobytes()


def decode_cor(pkt: bytes, npol: int = 2) -> tuple[CorHeader, np.ndarray]:
    (sync, id_frame, secs, freq, gain, time_tag, navg, stand_i,
     stand_j) = _COR5C_HDR.unpack_from(pkt)
    if sync != COR_SYNC_WORD:
        raise ValueError(f"bad COR sync word {sync:#x}")
    if (id_frame >> 24) != COR_ID:
        raise ValueError(f"bad COR packet id {id_frame >> 24:#x}")
    hdr = CorHeader(frame_number=id_frame & 0xFFFFFF, secs_count=secs,
                    freq_count=freq, cor_gain=gain, time_tag=time_tag,
                    cor_navg=navg, stand_i=stand_i, stand_j=stand_j)
    data = np.frombuffer(pkt, dtype=">i4", offset=_COR5C_HDR.size)
    return hdr, data.reshape(-1, npol, npol, 2)


def cor_scatter_matrix(packets, nstand: int, npol: int = 2,
                       nchan_tot: int | None = None) -> np.ndarray:
    """Reassemble COR packets into a full Hermitian visibility cube, the
    reference receiver's scatter with conjugation
    (corr_full_rx_bifrost_packets.py:96-103).

    Returns int64 [nstand, nstand, npol, npol, nchan_tot, 2].  Packets are
    decoded and scattered in groups of equal channel count and offset:
    each packet's direct entries first, then the conjugated mirror, which
    is the reference loop's result for any stream that lists each stand
    pair once (the autos' mirror is their own conjugate transpose).
    """
    out = None
    groups: dict = {}
    for pkt in packets:
        hdr, data = decode_cor(pkt, npol)
        if out is None:
            nc = nchan_tot or data.shape[0]
            out = np.zeros((nstand, nstand, npol, npol, nc, 2), np.int64)
        key = (hdr.freq_count % out.shape[4], data.shape[0])
        g = groups.setdefault(key, ([], [], []))
        g[0].append(hdr.stand_i - 1)
        g[1].append(hdr.stand_j - 1)
        g[2].append(data)
    for (c0, nchan), (si, sj, datas) in groups.items():
        i = np.asarray(si)
        j = np.asarray(sj)
        # [npkt, nchan, p0, p1, 2] -> [npkt, p0, p1, nchan, 2]
        d = np.stack(datas).astype(np.int64).transpose(0, 2, 3, 1, 4)
        out[i, j, :, :, c0:c0 + nchan] = d
        mirror = d.transpose(0, 2, 1, 3, 4).copy()
        mirror[..., 1] *= -1
        out[j, i, :, :, c0:c0 + nchan] = mirror
    return out


# ---------------------------------------------------------------------------
# Partial-correlation (subselected baselines) packets
# ---------------------------------------------------------------------------

@dataclass
class CorrPartHeader:
    sync_time: int
    spectra_id: int
    bw_hz: float
    sfreq_hz: float
    acc_len: int
    nvis: int
    nchans: int
    chan0: int


def encode_corr_part(hdr: CorrPartHeader, baselines: np.ndarray,
                     data: np.ndarray) -> bytes:
    """baselines: [nvis, 2, 2] uint32; data: int32 [nvis, nchans, 2]."""
    if baselines.shape != (hdr.nvis, 2, 2):
        raise ValueError("baselines shape mismatch")
    if data.shape != (hdr.nvis, hdr.nchans, 2):
        raise ValueError("payload shape mismatch")
    return (_COR_PART_HDR.pack(hdr.sync_time, hdr.spectra_id, hdr.bw_hz,
                               hdr.sfreq_hz, hdr.acc_len, hdr.nvis,
                               hdr.nchans, hdr.chan0)
            + np.ascontiguousarray(baselines, dtype=">u4").tobytes()
            + np.ascontiguousarray(data, dtype=">i4").tobytes())


def decode_corr_part(pkt: bytes) -> tuple[CorrPartHeader, np.ndarray,
                                          np.ndarray]:
    hdr = CorrPartHeader(*_COR_PART_HDR.unpack_from(pkt))
    off = _COR_PART_HDR.size
    nbl = hdr.nvis * 4
    baselines = np.frombuffer(pkt, dtype=">u4", offset=off,
                              count=nbl).reshape(hdr.nvis, 2, 2)
    data = np.frombuffer(pkt, dtype=">i4", offset=off + 4 * nbl)
    return hdr, baselines, data.reshape(hdr.nvis, hdr.nchans, 2)


# ---------------------------------------------------------------------------
# PBEAM (integrated power beams)
# ---------------------------------------------------------------------------

@dataclass
class PBeamHeader:
    server: int   # 1-indexed pipeline number
    beam: int     # 1-indexed beam number
    gbe: int      # "tuning", 0
    nchan: int
    nbeam: int    # beams per packet (1)
    nserver: int
    navg: int     # spectra averaged
    chan0: int
    seq: int


def encode_pbeam(hdr: PBeamHeader, data: np.ndarray) -> bytes:
    """data: f32 [nchan, nbeam, 4] (XX, YY, re(XY), im(XY))."""
    if data.shape != (hdr.nchan, hdr.nbeam, 4):
        raise ValueError("payload shape mismatch")
    return _PBEAM_HDR.pack(hdr.server, hdr.beam, hdr.gbe, hdr.nchan,
                           hdr.nbeam, hdr.nserver, hdr.navg, hdr.chan0,
                           hdr.seq) + \
        np.ascontiguousarray(data, dtype="<f4").tobytes()


def decode_pbeam(pkt: bytes) -> tuple[PBeamHeader, np.ndarray]:
    hdr = PBeamHeader(*_PBEAM_HDR.unpack_from(pkt))
    data = np.frombuffer(pkt, dtype="<f4", offset=_PBEAM_HDR.size)
    return hdr, data.reshape(hdr.nchan, hdr.nbeam, 4)


# ---------------------------------------------------------------------------
# IBEAM (voltage beams)
# ---------------------------------------------------------------------------

@dataclass
class IBeamHeader:
    server: int
    gbe: int
    nchan: int
    nbeam: int
    nserver: int
    chan0: int
    seq: int


def encode_ibeam(hdr: IBeamHeader, data: np.ndarray) -> bytes:
    """data: f32 [nchan, nbeam, 2] (re, im)."""
    if data.shape != (hdr.nchan, hdr.nbeam, 2):
        raise ValueError("payload shape mismatch")
    return _IBEAM_HDR.pack(hdr.server, hdr.gbe, hdr.nchan, hdr.nbeam,
                           hdr.nserver, hdr.chan0, hdr.seq) + \
        np.ascontiguousarray(data, dtype="<f4").tobytes()


def decode_ibeam(pkt: bytes) -> tuple[IBeamHeader, np.ndarray]:
    hdr = IBeamHeader(*_IBEAM_HDR.unpack_from(pkt))
    data = np.frombuffer(pkt, dtype="<f4", offset=_IBEAM_HDR.size)
    return hdr, data.reshape(hdr.nchan, hdr.nbeam, 2)
