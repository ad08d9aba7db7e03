"""Product sinks (port of ``caltech_bifrost_dsp_tpu/io/sink.py``): the
correlation and beam packet emitters.

- :class:`CorrFullOutput`: one dual-pol baseline per packet over the upper
  triangle of a slow dump, Mbps throttling every ~1 MB, and the golden
  checkfile gate (reference: blocks/corr_output_full_block.py:439-603).
  Two wire formats, the custom 56-byte header or the production LWA-SV
  "COR" Mark5C format (``use_cor_fmt``).  Packets are built from the int32
  planes a whole stand row at a time; the bytes equal the JAX sink's
  per-baseline encoding.
- :class:`CorrPartOutput`: subselected visibilities, ``nvis_per_packet``
  per packet with the baseline map in each header, or one COR packet per
  dual-pol baseline (corr_output_part_block.py:346-401).
- :class:`PBeamOutput`: per-beam PBEAM streams (beamform_output_block.py).
- :class:`IBeamOutput`: IBEAM voltage packets, burst-throttled to 0.6 Gb/s
  (beamform_vlbi_output_block.py:202-275).

Writers take a ``send`` callable (a :class:`UdpSender` or a collector), so
tests capture packets without a network; ``send=None`` emits nothing.
"""

from __future__ import annotations

import os
import socket
import time

import numpy as np

from ..ops.corr_subsel import subsel_output_sfreq
from ..utils.proclog import PerfTimer
from . import packets as pk


class Throttle:
    """Rate cap: sleep after every ~1 MB block when over rate
    (corr_output_full_block.py:462-473)."""

    def __init__(self, max_bps: float | None, block_bits: int = 8_000_000):
        self.max_bps = max_bps
        self.block_bits = block_bits
        self._bits = 0
        self._t0 = time.monotonic()

    def account(self, nbits: int) -> None:
        if not self.max_bps or self.max_bps <= 0:
            return
        self._bits += nbits
        if self._bits >= self.block_bits:
            elapsed = time.monotonic() - self._t0
            min_time = self._bits / self.max_bps
            if min_time > elapsed:
                time.sleep(min_time - elapsed)
            self._t0 = time.monotonic()
            self._bits = 0


class UdpSender:
    def __init__(self, dest_ip: str, dest_port: int):
        self.dest = (dest_ip, dest_port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def __call__(self, payload: bytes) -> None:
        self.sock.sendto(payload, self.dest)


def udp_rx_socket(ip: str, port: int, rcvbuf_mb: int = 64,
                  timeout_s: float | None = None):
    """Bound receive socket with a deep kernel buffer, the set-up of every
    product-stream receiver."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                    rcvbuf_mb * 1024 * 1024)
    sock.bind((ip, port))
    if timeout_s is not None:
        sock.settimeout(timeout_s)
    return sock


def _cor_header_fields(cfg, sync_time: int, spectra_id: int,
                       acc_len: int, nchan_sum: int = 1):
    """Mark5C header arithmetic in ADC-sample time units
    (corr_output_full_block.py:624,676-677): (frame_number, secs_count,
    freq_count, time_tag, navg)."""
    sps = int(round(cfg.fs_hz / cfg.chan_bw_hz))
    return (pk.cor_frame_number(nchan_sum, cfg.npipeline,
                                cfg.pipeline_id + 1),
            int(sync_time + spectra_id / cfg.spectra_rate_hz)
            & 0xFFFFFFFF,
            cfg.chan0 & 0xFFFF, spectra_id * sps, acc_len * sps)


class CorrFullOutput:
    """Emit a slow-dump visibility matrix as full-correlation packets."""

    def __init__(self, cfg, send=None, max_mbps: int = -1,
                 checkfile: str | None = None, checkfile_acc_len: int = 0,
                 use_cor_fmt: bool = False):
        self.cfg = cfg
        self.send = send
        self.max_mbps = max_mbps
        self.use_cor_fmt = use_cor_fmt
        self.throttle = Throttle(max_mbps * 1e6 if max_mbps > 0 else None)
        self.perf = PerfTimer()
        self.checkfile = checkfile
        self.checkfile_acc_len = checkfile_acc_len
        self.check_failures = 0
        self.check_count = 0

    def _load_checkfile_corr(self, t_index: int) -> np.ndarray:
        """One golden integration, looping the file
        (corr_output_full_block.py get_checkfile_corr)."""
        cfg = self.cfg
        dim = (cfg.nchan, cfg.nstand, cfg.nstand, cfg.npol, cfg.npol)
        nbyte = int(np.prod(dim)) * 16
        fsize = os.path.getsize(self.checkfile)
        with open(self.checkfile, "rb") as fh:
            # skip the one-line JSON header if present
            first = fh.readline()
            base = len(first) if first.startswith(b"{") else 0
            payload = fsize - base
            fh.seek(base + (nbyte * t_index) % payload)
            raw = fh.read(nbyte)
        return np.frombuffer(raw, np.complex128).reshape(dim)

    def check_against_file(self, vis_re: np.ndarray, vis_im: np.ndarray,
                           acc_len: int, t_index: int) -> bool:
        """Integrate the golden file up to ``acc_len`` and compare the dense
        int32 planes exactly (corr_output_full_block.py:550-603 repetition
        arithmetic)."""
        if acc_len % self.checkfile_acc_len:
            raise ValueError("slow acc_len is not a multiple of the "
                             "checkfile's acc_len")
        nrep = acc_len // self.checkfile_acc_len
        t0 = t_index * nrep
        want = sum(self._load_checkfile_corr(t0 + i) for i in range(nrep))
        cfg = self.cfg
        g = want.transpose(0, 1, 3, 2, 4).reshape(cfg.nchan, cfg.ninput,
                                                  cfg.ninput)
        ok = bool(np.array_equal(g.real, vis_re)
                  and np.array_equal(g.imag, vis_im))
        self.check_count += 1
        if not ok:
            self.check_failures += 1
        return ok

    def send_matrix(self, vis_dense: np.ndarray, sync_time: int,
                    spectra_id: int, acc_len: int) -> int:
        """:meth:`send_matrix_planes` of a dense complex matrix [nchan,
        ninput, ninput] with integer parts."""
        return self.send_matrix_planes(
            np.real(vis_dense).astype(np.int32),
            np.imag(vis_dense).astype(np.int32), sync_time, spectra_id,
            acc_len)

    def send_matrix_planes(self, vis_re: np.ndarray, vis_im: np.ndarray,
                           sync_time: int, spectra_id: int,
                           acc_len: int) -> int:
        """Packetize the upper triangle of int32 planes [nchan, ninput,
        ninput], one dual-pol baseline (stand s0, stand s1 >= s0) per
        packet.  Returns packets sent."""
        if self.send is None:
            return 0
        cfg = self.cfg
        nchan, nstand, npol = cfg.nchan, cfg.nstand, cfg.npol
        self.perf.tick()
        re5 = np.asarray(vis_re).reshape(nchan, nstand, npol, nstand, npol)
        im5 = np.asarray(vis_im).reshape(nchan, nstand, npol, nstand, npol)
        frame_number, secs, freq, time_tag, navg = _cor_header_fields(
            cfg, sync_time, spectra_id, acc_len)
        bw_hz = cfg.nchan * cfg.chan_bw_hz
        # [chan, p0, nj, p1] -> per packet j: COR [chan, p0, p1, 2],
        # custom [p0, p1, chan, 2]
        order = (2, 0, 1, 3) if self.use_cor_fmt else (2, 1, 3, 0)
        npkt = 0
        for s0 in range(nstand):
            re = re5[:, s0, :, s0:, :].transpose(order)
            data = np.empty(re.shape + (2,), ">i4")
            data[..., 0] = re
            data[..., 1] = im5[:, s0, :, s0:, :].transpose(order)
            for j in range(data.shape[0]):
                if self.use_cor_fmt:
                    pkt = pk.encode_cor(pk.CorHeader(
                        frame_number=frame_number, secs_count=secs,
                        freq_count=freq, cor_gain=0, time_tag=time_tag,
                        cor_navg=navg, stand_i=s0 + 1,
                        stand_j=s0 + j + 1), data[j])
                else:
                    pkt = pk.encode_corr_full(pk.CorrFullHeader(
                        sync_time=sync_time, spectra_id=spectra_id,
                        bw_hz=bw_hz, sfreq_hz=cfg.sfreq_hz,
                        acc_len=acc_len, nchans=nchan, chan0=cfg.chan0,
                        npols=npol, stand0=s0, stand1=s0 + j), data[j])
                self.send(pkt)
                self.throttle.account(8 * len(pkt))
                npkt += 1
        hdr_nbyte = 32 if self.use_cor_fmt else 56
        self.perf.mark_process(npkt * (hdr_nbyte + npol * npol * nchan * 8))
        return npkt


class CorrPartOutput:
    """Emit subselected visibilities, nvis_per_packet per packet
    (corr_output_part_block.py:346-364)."""

    def __init__(self, cfg, send=None, nvis_per_packet: int = 16,
                 max_mbps: int = -1, use_cor_fmt: bool = False):
        self.cfg = cfg
        self.send = send
        self.nvis_per_packet = nvis_per_packet
        self.use_cor_fmt = use_cor_fmt
        self.throttle = Throttle(max_mbps * 1e6 if max_mbps > 0 else None)

    def _send_subsel_cor(self, subsel_re: np.ndarray,
                         subsel_im: np.ndarray, baselines, spectra_id: int,
                         acc_len: int, sync_time: int) -> int:
        """COR-format fast visibilities, one dual-pol baseline per packet.
        Stand labels come from the baselines map (each consecutive npol^2
        group's stand pair) or, without one, from the upper-triangle
        enumeration bifrost's packetizer assumes
        (corr_output_part_block.py:366-401)."""
        cfg = self.cfg
        nchan_out, nvis = subsel_re.shape
        npp = cfg.npol * cfg.npol
        nbl = nvis // npp
        if baselines is not None:
            blmap = np.asarray(baselines).reshape(nbl, npp, 2, 2)
            stand_pairs = [(int(blmap[b, 0, 0, 0]) + 1,
                            int(blmap[b, 0, 1, 0]) + 1)
                           for b in range(nbl)]
        else:
            nstand_virt = int((-1 + np.sqrt(1 + 8 * nbl)) / 2)
            stand_pairs = [(i + 1, j + 1)
                           for i in range(nstand_virt)
                           for j in range(i, nstand_virt)][:nbl]
        frame_number, secs, freq, time_tag, navg = _cor_header_fields(
            cfg, sync_time, spectra_id, acc_len, nchan_sum=cfg.nchan_sum)
        re = subsel_re.reshape(nchan_out, nbl, cfg.npol, cfg.npol)
        im = subsel_im.reshape(nchan_out, nbl, cfg.npol, cfg.npol)
        npkt = 0
        for b, (si, sj) in enumerate(stand_pairs):
            data = np.empty((nchan_out, cfg.npol, cfg.npol, 2), np.int32)
            data[..., 0] = re[:, b]
            data[..., 1] = im[:, b]
            pkt = pk.encode_cor(pk.CorHeader(
                frame_number=frame_number, secs_count=secs,
                freq_count=freq, cor_gain=0, time_tag=time_tag,
                cor_navg=navg, stand_i=si, stand_j=sj), data)
            self.send(pkt)
            self.throttle.account(8 * len(pkt))
            npkt += 1
        return npkt

    def send_subsel(self, subsel_re: np.ndarray, subsel_im: np.ndarray,
                    baselines: np.ndarray, sync_time: int, spectra_id: int,
                    acc_len: int) -> int:
        if self.send is None:
            return 0
        cfg = self.cfg
        if self.use_cor_fmt:
            return self._send_subsel_cor(subsel_re, subsel_im, baselines,
                                         spectra_id, acc_len, sync_time)
        nchan_out, nvis = subsel_re.shape
        bl = np.asarray(baselines, np.uint32)
        sfreq = subsel_output_sfreq(cfg.sfreq_hz,
                                    cfg.nchan * cfg.chan_bw_hz,
                                    cfg.nchan, cfg.nchan_sum)
        npkt = 0
        for v0 in range(0, nvis, self.nvis_per_packet):
            v1 = min(v0 + self.nvis_per_packet, nvis)
            data = np.empty((v1 - v0, nchan_out, 2), np.int32)
            data[..., 0] = subsel_re[:, v0:v1].T
            data[..., 1] = subsel_im[:, v0:v1].T
            hdr = pk.CorrPartHeader(
                sync_time=sync_time, spectra_id=spectra_id,
                bw_hz=cfg.nchan * cfg.chan_bw_hz, sfreq_hz=sfreq,
                acc_len=acc_len, nvis=v1 - v0, nchans=nchan_out,
                chan0=cfg.chan0 // cfg.nchan_sum)
            pkt = pk.encode_corr_part(hdr, bl[v0:v1], data)
            self.send(pkt)
            self.throttle.account(8 * len(pkt))
            npkt += 1
        return npkt


class PBeamOutput:
    """Per-beam PBEAM streams; one packet per integration per beam."""

    def __init__(self, cfg, senders: dict[int, object] | None = None,
                 pipeline_idx: int = 1):
        self.cfg = cfg
        self.senders = senders or {}
        self.pipeline_idx = pipeline_idx

    def send_powers(self, power: np.ndarray, seq0: int, navg: int) -> int:
        """power: f32 [nbeam//2, nblock, nchan, 4]."""
        cfg = self.cfg
        npkt = 0
        _, nblock, nchan, _ = power.shape
        for b, send in self.senders.items():
            for t in range(nblock):
                hdr = pk.PBeamHeader(
                    server=self.pipeline_idx, beam=b + 1, gbe=0,
                    nchan=nchan, nbeam=1, nserver=cfg.npipeline,
                    navg=navg, chan0=cfg.chan0, seq=seq0 + t * navg)
                send(pk.encode_pbeam(hdr, power[b, t][:, None, :]))
                npkt += 1
        return npkt


class IBeamOutput:
    """VLBI voltage-beam stream, burst-throttled
    (beamform_vlbi_output_block.py:202-275)."""

    MAX_BPS = 0.6e9

    def __init__(self, cfg, send=None, pipeline_idx: int = 1,
                 npacket_burst: int = 32):
        self.cfg = cfg
        self.send = send
        self.pipeline_idx = pipeline_idx
        self.throttle = Throttle(self.MAX_BPS,
                                 block_bits=npacket_burst * 8 * 1500)

    def send_voltages(self, vlbi: np.ndarray, seq0: int) -> int:
        """vlbi: f32 [ntime, nchan, nbeam, 2]."""
        if self.send is None:
            return 0
        ntime, nchan, nbeam, _ = vlbi.shape
        npkt = 0
        for t in range(ntime):
            hdr = pk.IBeamHeader(server=self.pipeline_idx, gbe=0,
                                 nchan=nchan, nbeam=nbeam,
                                 nserver=self.cfg.npipeline,
                                 chan0=self.cfg.chan0, seq=seq0 + t)
            pkt = pk.encode_ibeam(hdr, vlbi[t])
            self.send(pkt)
            self.throttle.account(8 * len(pkt))
            npkt += 1
        return npkt
