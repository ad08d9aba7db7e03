"""Product sinks (port of ``caltech_bifrost_dsp_tpu/io/sink.py``): the
correlation and beam packet emitters.

- :class:`CorrFullOutput`: one dual-pol baseline per packet over the upper
  triangle of a slow dump, Mbps throttling every ~1 MB, and the golden
  checkfile gate (reference: blocks/corr_output_full_block.py:439-603).
  Two wire formats, the custom 56-byte header or the production LWA-SV
  "COR" Mark5C format (``use_cor_fmt``).  Packets are built from the int32
  planes a whole stand row at a time; the bytes equal the JAX sink's
  per-baseline encoding.  With ``native_dest`` the C++ packetizer of
  :mod:`.native` builds and sends the same bytes.
- :class:`CorrPartOutput`: subselected visibilities, ``nvis_per_packet``
  per packet with the baseline map in each header, or one COR packet per
  dual-pol baseline (corr_output_part_block.py:346-401).
- :class:`PBeamOutput`: per-beam PBEAM streams (beamform_output_block.py).
- :class:`IBeamOutput`: IBEAM voltage packets, burst-throttled to 0.6 Gb/s
  (beamform_vlbi_output_block.py:202-275).
- :class:`ProductKeeper`: every product kept on the host, none sent.
- :class:`TriggeredDump`: the transient voltage recorder's writer, the
  history ring to self-describing files (triggered_dump_block.py); the
  files equal the JAX writer's byte for byte.

Writers take a ``send`` callable (a :class:`UdpSender` or a collector), so
tests capture packets without a network; ``send=None`` emits nothing.
Each keeps :class:`SinkCounters` (``counters``): packets, bytes, seconds in
its calls and in its throttle's sleeps, always; with spans on
(:mod:`..utils.proclog`), each call is an ``output.<name>`` span, each
throttle sleep an ``output.<name>.throttle`` span inside it, and the call's
seconds are split into ``send`` and the rest (the encode).
"""

from __future__ import annotations

import json
import os
import socket
import time

import numpy as np

from ..ops.corr_subsel import subsel_output_sfreq
from ..utils import proclog
from . import native
from . import packets as pk


class Throttle:
    """Rate cap: sleep after every ~1 MB block when over rate
    (corr_output_full_block.py:462-473)."""

    def __init__(self, max_bps: float | None, block_bits: int = 8_000_000):
        self.max_bps = max_bps
        self.block_bits = block_bits
        self._bits = 0
        self._t0 = time.monotonic()

    def account(self, nbits: int) -> float:
        """Count ``nbits`` sent; returns the seconds slept for them."""
        if not self.max_bps or self.max_bps <= 0:
            return 0.0
        self._bits += nbits
        if self._bits < self.block_bits:
            return 0.0
        now = time.monotonic()
        min_time = self._bits / self.max_bps
        slept = 0.0
        if min_time > now - self._t0:
            with proclog.span(".throttle"):
                time.sleep(min_time - (now - self._t0))
            t = time.monotonic()
            slept, now = t - now, t
        self._t0 = now
        self._bits = 0
        return slept


class SinkCounters:
    """A sink's accounting, always on: ``npkt`` and ``nbyte`` sent,
    ``process_time`` (seconds in its calls) and ``throttle_s`` (seconds
    its throttle slept); with spans on, ``send_s`` (seconds in ``send``)
    and ``encode_s`` (the rest of a call less the throttle's sleep).
    :meth:`call` wraps one call of the sink as span ``output.<name>``;
    :meth:`publish` is the record of the sink's ``perf`` proclog, which
    also names the ``server`` (1-indexed pipeline) that a beam sink's
    headers carry, so the monitor shows which pipeline a stream claims
    to be."""

    def __init__(self, name: str, server: int | None = None):
        self.span_name = "output." + name
        self.server = server
        self.npkt = self.nbyte = 0
        self.process_time = self.throttle_s = 0.0
        self.encode_s = self.send_s = 0.0

    def call(self, window: int, send=None, throttle=None) -> "_SinkCall":
        """Context of one call serving fast window ``window``; it sends
        with ``send`` (or the send it is given) and accounts each packet
        with ``throttle``."""
        return _SinkCall(self, window, send, throttle)

    def publish(self) -> dict:
        rec = {"acquire_time": 0.0, "reserve_time": 0.0,
               "process_time": self.process_time,
               "gbps": (8 * self.nbyte / self.process_time / 1e9
                        if self.process_time > 0 else 0.0),
               "npkt": self.npkt, "nbyte": self.nbyte,
               "throttle_s": self.throttle_s, "encode_s": self.encode_s,
               "send_s": self.send_s}
        if self.server is not None:
            rec["server"] = self.server
        return rec


class _SinkCall:
    """One sink call: ``self(pkt)`` sends a packet, counts it and lets the
    throttle account for it; the call's totals reach the counters on
    leaving the ``with``."""

    def __init__(self, counters: SinkCounters, window: int, send,
                 throttle):
        self.counters, self.window = counters, window
        self.send, self.throttle = send, throttle
        self.npkt = self.nbyte = 0
        self.throttle_s = self.send_s = 0.0

    def __enter__(self) -> "_SinkCall":
        self.span = proclog.span(self.counters.span_name, self.window)
        self.t0 = time.perf_counter()
        return self

    def __call__(self, pkt: bytes, send=None) -> None:
        if send is None:
            send = self.send
        if self.span:
            t = time.perf_counter()
            send(pkt)
            self.send_s += time.perf_counter() - t
        else:
            send(pkt)
        self.add(1, len(pkt))
        if self.throttle is not None:
            self.throttle_s += self.throttle.account(8 * len(pkt))

    def add(self, npkt: int, nbyte: int) -> None:
        """Count packets sent elsewhere (the native packetizer)."""
        self.npkt += npkt
        self.nbyte += nbyte

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        c = self.counters
        c.npkt += self.npkt
        c.nbyte += self.nbyte
        c.process_time += dt
        c.throttle_s += self.throttle_s
        if self.span:
            c.send_s += self.send_s
            c.encode_s += dt - self.send_s - self.throttle_s
        self.span.close()


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
    """Emit a slow-dump visibility matrix as full-correlation packets.

    ``native_dest=(ip, port)`` hands each dump to the C++ packetizer
    (:func:`.native.cor_send_matrix`, :func:`.native.cor5c_send_matrix`),
    which sends the same bytes as the Python encoder to that address with
    the same ``max_mbps`` throttle; ``send`` is then not used.  The library
    is loaded here, and a failure to build or load it raises.  (The JAX
    sink falls back to the Python encoder instead; the packets would be the
    same, but the fallback would hide which encoder a measurement timed.)
    """

    def __init__(self, cfg, send=None, max_mbps: int = -1,
                 checkfile: str | None = None, checkfile_acc_len: int = 0,
                 native_dest: tuple[str, int] | None = None,
                 use_cor_fmt: bool = False):
        self.cfg = cfg
        self.send = send
        self.max_mbps = max_mbps
        self.native_dest = native_dest
        if native_dest is not None:
            native.load()
        self.use_cor_fmt = use_cor_fmt
        # write_autos: a directory for per-dump autocorrelation spectra
        # (.npy), None = off; set by the output command block
        self.autos_path: str | None = None
        self.throttle = Throttle(max_mbps * 1e6 if max_mbps > 0 else None)
        self.counters = SinkCounters("cor")
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

    def write_autos(self, vis_dense: np.ndarray, spectra_id: int) -> str:
        """Dump per-stand autocorrelation spectra (real f32 [nstand, npol,
        nchan]) of a dense complex matrix to
        ``<autos_path>/autos_<spectra_id>.npy``."""
        return self._write_autos_planes(np.real(vis_dense), spectra_id)

    def _write_autos_planes(self, vis_re: np.ndarray,
                            spectra_id: int) -> str:
        """:meth:`write_autos` from the real int32 plane: autocorrelations
        are real, so its diagonal suffices."""
        from ..ops.correlate import autocorr_spectra

        autos = autocorr_spectra(vis_re, self.cfg.nstand, self.cfg.npol)
        fname = os.path.join(self.autos_path, "autos_%d.npy" % spectra_id)
        np.save(fname, autos)
        return fname

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
        packet.  Returns packets sent.

        The planes are valid until this call returns (on a card the driver
        fetches the next slow dump into the same page-locked pair); the
        encoders, the native packetizer, the autocorrelation file and the
        checkfile comparison keep nothing of them."""
        if self.autos_path:
            self._write_autos_planes(np.asarray(vis_re), spectra_id)
        if self.native_dest is not None:
            return self._send_native(vis_re, vis_im, sync_time, spectra_id,
                                     acc_len)
        if self.send is None:
            return 0
        cfg = self.cfg
        nchan, nstand, npol = cfg.nchan, cfg.nstand, cfg.npol
        re5 = np.asarray(vis_re).reshape(nchan, nstand, npol, nstand, npol)
        im5 = np.asarray(vis_im).reshape(nchan, nstand, npol, nstand, npol)
        frame_number, secs, freq, time_tag, navg = _cor_header_fields(
            cfg, sync_time, spectra_id, acc_len)
        bw_hz = cfg.nchan * cfg.chan_bw_hz
        # [chan, p0, nj, p1] -> per packet j: COR [chan, p0, p1, 2],
        # custom [p0, p1, chan, 2]
        order = (2, 0, 1, 3) if self.use_cor_fmt else (2, 1, 3, 0)
        with self.counters.call(spectra_id // cfg.acc_len, self.send,
                                self.throttle) as out:
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
                    out(pkt)
        return out.npkt

    def _send_native(self, vis_re, vis_im, sync_time: int, spectra_id: int,
                     acc_len: int) -> int:
        """The C++ packetizer's branch of :meth:`send_matrix_planes`
        (``caltech_bifrost_dsp_tpu/io/sink.py:127-162``)."""
        cfg = self.cfg
        ip, port = self.native_dest
        with self.counters.call(spectra_id // cfg.acc_len) as out:
            if self.use_cor_fmt:
                fn, secs, freq, time_tag, navg = _cor_header_fields(
                    cfg, sync_time, spectra_id, acc_len)
                npkt = native.cor5c_send_matrix(
                    vis_re, vis_im, cfg.nstand, cfg.npol, fn, secs, freq,
                    time_tag, navg, dest_ip=ip, port=port,
                    max_mbps=float(self.max_mbps))
            else:
                npkt = native.cor_send_matrix(
                    vis_re, vis_im, cfg.nstand, cfg.npol, sync_time,
                    spectra_id, cfg.nchan * cfg.chan_bw_hz, cfg.sfreq_hz,
                    acc_len, cfg.chan0, dest_ip=ip, port=port,
                    max_mbps=float(self.max_mbps))
            hdr_nbyte = 32 if self.use_cor_fmt else 56
            out.add(npkt, npkt * (hdr_nbyte
                                  + cfg.npol * cfg.npol * cfg.nchan * 8))
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
        self.counters = SinkCounters("subsel")

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
        with self._call(spectra_id) as out:
            for b, (si, sj) in enumerate(stand_pairs):
                data = np.empty((nchan_out, cfg.npol, cfg.npol, 2),
                                np.int32)
                data[..., 0] = re[:, b]
                data[..., 1] = im[:, b]
                out(pk.encode_cor(pk.CorHeader(
                    frame_number=frame_number, secs_count=secs,
                    freq_count=freq, cor_gain=0, time_tag=time_tag,
                    cor_navg=navg, stand_i=si, stand_j=sj), data))
        return out.npkt

    def _call(self, spectra_id: int):
        return self.counters.call(spectra_id // self.cfg.acc_len, self.send,
                                  self.throttle)

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
        with self._call(spectra_id) as out:
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
                out(pk.encode_corr_part(hdr, bl[v0:v1], data))
        return out.npkt


class PBeamOutput:
    """Per-beam PBEAM streams; one packet per integration per beam.
    ``pipeline_idx`` is the headers' ``server``, the 1-indexed pipeline: by
    default ``cfg.pipeline_id + 1``, the COR frame number's rule
    (:func:`_cor_header_fields`)."""

    def __init__(self, cfg, senders: dict[int, object] | None = None,
                 pipeline_idx: int | None = None):
        self.cfg = cfg
        self.senders = senders or {}
        self.pipeline_idx = (cfg.pipeline_id + 1 if pipeline_idx is None
                             else pipeline_idx)
        self.counters = SinkCounters("pbeam", server=self.pipeline_idx)

    def send_powers(self, power: np.ndarray, seq0: int, navg: int) -> int:
        """power: f32 [nbeam//2, nblock, nchan, 4]."""
        cfg = self.cfg
        _, nblock, nchan, _ = power.shape
        with self.counters.call(seq0 // cfg.acc_len) as out:
            for b, send in self.senders.items():
                for t in range(nblock):
                    hdr = pk.PBeamHeader(
                        server=self.pipeline_idx, beam=b + 1, gbe=0,
                        nchan=nchan, nbeam=1, nserver=cfg.npipeline,
                        navg=navg, chan0=cfg.chan0, seq=seq0 + t * navg)
                    out(pk.encode_pbeam(hdr, power[b, t][:, None, :]), send)
        return out.npkt


class IBeamOutput:
    """VLBI voltage-beam stream, burst-throttled
    (beamform_vlbi_output_block.py:202-275).  ``pipeline_idx`` is the
    headers' ``server``, by default ``cfg.pipeline_id + 1``."""

    MAX_BPS = 0.6e9

    def __init__(self, cfg, send=None, pipeline_idx: int | None = None,
                 npacket_burst: int = 32):
        self.cfg = cfg
        self.send = send
        self.pipeline_idx = (cfg.pipeline_id + 1 if pipeline_idx is None
                             else pipeline_idx)
        self.throttle = Throttle(self.MAX_BPS,
                                 block_bits=npacket_burst * 8 * 1500)
        self.counters = SinkCounters("ibeam", server=self.pipeline_idx)

    def send_voltages(self, vlbi: np.ndarray, seq0: int) -> int:
        """vlbi: f32 [ntime, nchan, nbeam, 2]."""
        if self.send is None:
            return 0
        ntime, nchan, nbeam, _ = vlbi.shape
        with self.counters.call(seq0 // self.cfg.acc_len, self.send,
                                self.throttle) as out:
            for t in range(ntime):
                hdr = pk.IBeamHeader(server=self.pipeline_idx, gbe=0,
                                     nchan=nchan, nbeam=nbeam,
                                     nserver=self.cfg.npipeline,
                                     chan0=self.cfg.chan0, seq=seq0 + t)
                out(pk.encode_ibeam(hdr, vlbi[t]))
        return out.npkt


class ProductKeeper:
    """A sink of every product that keeps them on the host instead of
    sending them, for the CLI's ``--save-slow``, tests and the smoke run.

    Each product is kept under the spectra index it starts at: ``slow``
    and ``subsel`` hold (real, imag) planes, ``power`` the PBEAM powers
    [nbeam//2, nblock, nchan, 4] and ``vlbi`` the voltages [ntime, nchan,
    nbeam, 2], as the driver hands them over.  ``keep`` bounds each to
    its newest ``keep`` entries.  One keeper may sit in all four of the
    driver's sink lists."""

    checkfile = None

    def __init__(self, keep: int | None = None):
        self.keep = keep
        self.slow: dict = {}
        self.subsel: dict = {}
        self.power: dict = {}
        self.vlbi: dict = {}

    def _put(self, kept: dict, seq0: int, value) -> int:
        kept[seq0] = value
        while self.keep is not None and len(kept) > self.keep:
            del kept[next(iter(kept))]
        return 0

    def send_matrix_planes(self, vis_re, vis_im, sync_time, spectra_id,
                           acc_len) -> int:
        """Keep copies: the planes handed over are valid only until this
        call returns."""
        return self._put(self.slow, spectra_id,
                         (np.array(vis_re), np.array(vis_im)))

    def send_subsel(self, subsel_re, subsel_im, baselines, sync_time,
                    spectra_id, acc_len) -> int:
        return self._put(self.subsel, spectra_id, (subsel_re, subsel_im))

    def send_powers(self, power, seq0, navg) -> int:
        return self._put(self.power, seq0, power)

    def send_voltages(self, vlbi, seq0) -> int:
        return self._put(self.vlbi, seq0, vlbi)


class TriggeredDump:
    """Dump the deep history ring to self-describing files.

    A file is an 8-byte little-endian total-size prefix, the JSON header
    padded into a 1 MB block, then the raw frames (triggered_dump_block.py:
    131-151, 176-179, 264-268); commands trigger/abort/stop with
    ntime_per_file / nfile / dump_path (164-169); a dump starts at the
    earliest resident frame (218).

    ``direct`` writes with O_DIRECT|O_SYNC, the reference's sustained-dump
    mode (triggered_dump_block.py:260-263); where the filesystem refuses
    O_DIRECT (tmpfs, for one) the file is written buffered, as the
    reference's writer does.  ``last_direct`` says which wrote the last
    file.
    """

    HEADER_BLOCK = 1024 * 1024

    def __init__(self, history_ring, dump_path: str = ".",
                 file_prefix: str = "lwa-dump", direct: bool = False):
        self.ring = history_ring
        self.dump_path = dump_path
        self.file_prefix = file_prefix
        self.direct = direct
        self.abort_requested = False
        self.last_direct: bool | None = None

    def trigger(self, ntime_per_file: int, nfile: int = 1,
                dump_path: str | None = None) -> list[str]:
        """Write up to ``nfile`` files of ``ntime_per_file`` samples each
        from the earliest resident frame on; returns their paths."""
        # an abort issued while no dump ran must not cancel this trigger
        self.abort_requested = False
        path = dump_path or self.dump_path
        files = []
        hdr0 = self.ring.header
        # samples per ring frame: a packed frame holds [ntime, nchan,
        # ninput] bytes, an ADC frame [nsamp, ninput] samples of nbit
        if hdr0.get("adc"):
            sample_nbyte = (hdr0.get("nbit", 32) // 8
                            * hdr0.get("nstand", 1) * hdr0.get("npol", 1))
        else:
            sample_nbyte = (hdr0.get("nchan", 1) * hdr0.get("nstand", 1)
                            * hdr0.get("npol", 1)) or 1
        spf = max(1, self.ring.frame_nbyte // sample_nbyte)
        # sequence step per frame: one ntime_gulp in both modes (ADC
        # sequences count output spectra, io/native.py AdcCaptureSource),
        # so the 2*nchan ADC samples of a spectrum stay out of seq0
        seq_pf = (max(1, spf // (2 * hdr0["nchan"]))
                  if hdr0.get("adc") and hdr0.get("nchan")
                  else spf)
        frames_per_file = max(1, -(-ntime_per_file // spf))
        lo = self.ring.earliest()
        for i in range(nfile):
            if self.abort_requested:
                break
            # capture keeps pushing during the dump; where it lapped the
            # cursor, skip forward to the earliest resident frame (the
            # reference reopens at the earliest, triggered_dump_block.py:218)
            while True:
                lo = max(lo, self.ring.earliest())
                n = min(frames_per_file, self.ring.count - lo)
                if n <= 0:
                    break
                try:
                    data = self.ring.snapshot(lo, n)
                    break
                except IndexError:
                    continue  # lapped between earliest() and snapshot()
            if n <= 0:
                break
            hdr = dict(hdr0)
            hdr.update({"ntime": n * spf,
                        "seq0": self.ring.frame0_seq + lo * seq_pf,
                        "dump_index": i})
            fname = os.path.join(
                path, "%s_%d_%d.tbf" % (self.file_prefix,
                                        hdr.get("seq0", 0), i))
            self._write_file(fname, hdr, data)
            files.append(fname)
            lo += n
        self.abort_requested = False
        return files

    def _write_file(self, fname: str, header: dict, data: np.ndarray
                    ) -> None:
        hdr_json = json.dumps(header).encode()
        if len(hdr_json) > self.HEADER_BLOCK - 8:
            raise ValueError("header too large")
        total = self.HEADER_BLOCK + data.nbytes
        self.last_direct = bool(self.direct and self._write_file_direct(
            fname, hdr_json, data, total))
        if self.last_direct:
            return
        with open(fname, "wb") as fh:
            fh.write(total.to_bytes(8, "little"))
            fh.write(hdr_json)
            fh.write(b"\x00" * (self.HEADER_BLOCK - 8 - len(hdr_json)))
            fh.write(data.tobytes())

    def _write_file_direct(self, fname: str, hdr_json: bytes,
                           data: np.ndarray, total: int) -> bool:
        """O_DIRECT|O_SYNC writes of whole pages from a page-aligned mmap
        bounce buffer; the tail under a page is appended buffered.  Returns
        False where the filesystem refuses O_DIRECT."""
        import mmap

        if not hasattr(os, "O_DIRECT"):
            return False
        try:
            fd = os.open(fname, os.O_WRONLY | os.O_CREAT | os.O_TRUNC
                         | os.O_DIRECT | os.O_SYNC, 0o644)
        except OSError:
            return False
        try:
            raw = memoryview(data).cast("B")
            chunk_n = 32 << 20
            buf = mmap.mmap(-1, max(self.HEADER_BLOCK, chunk_n))
            # slicing an mmap gives an unaligned bytes copy, which O_DIRECT
            # refuses: write memoryview slices of the aligned mapping
            mv = memoryview(buf)
            buf[:8] = total.to_bytes(8, "little")
            buf[8:8 + len(hdr_json)] = hdr_json
            buf[8 + len(hdr_json):self.HEADER_BLOCK] = \
                b"\x00" * (self.HEADER_BLOCK - 8 - len(hdr_json))

            def write_all(view):
                # a short write (a signal, ENOSPC) is retried from where it
                # stopped; an offset that breaks O_DIRECT alignment raises
                # EINVAL and the caller writes the file buffered
                done = 0
                while done < len(view):
                    n = os.write(fd, view[done:])
                    if n <= 0:
                        raise OSError("short write to %s" % fname)
                    done += n

            write_all(mv[:self.HEADER_BLOCK])
            aligned = len(raw) // 4096 * 4096
            off = 0
            while off < aligned:
                n = min(chunk_n, aligned - off)
                buf[:n] = raw[off:off + n]
                write_all(mv[:n])
                off += n
            os.close(fd)
            fd = -1
            if aligned < len(raw):
                with open(fname, "ab") as fh:
                    fh.write(raw[aligned:])
            return True
        except OSError:
            if fd >= 0:
                os.close(fd)
            return False

    def abort(self) -> None:
        self.abort_requested = True
