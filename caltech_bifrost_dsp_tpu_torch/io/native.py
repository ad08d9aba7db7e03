"""ctypes bindings for the native capture/transmit engine (port of
``caltech_bifrost_dsp_tpu/io/native.py``).

The C++ sources are the repository's ``native/`` (``capture.cpp``,
``xdp_capture.cpp``, ``transmit.cpp``, ``cor_writer.cpp``; framework-free,
read and never written here).  :func:`build` compiles them with ``g++`` and
the flags of ``native/Makefile``, with one header of the port's forced in
(``native_compat.h``: ``recvmmsg`` with ``MSG_WAITFORONE`` where a kernel
refuses that flag), into
``caltech_bifrost_dsp_tpu_torch/_build/libcbd_native_<hash>.so``, named by
a hash of the sources, headers and flags and built under a file lock, so
an edited source rebuilds, concurrent processes build once, and the
library ``native/Makefile`` makes for the JAX package is never built,
loaded or touched.  Nothing is built at import.

- :class:`NativeCapture`: the C++ RX thread (recvmmsg, or AF_XDP with
  ``xdp_ifname``) assembling snap2 packets into gulps.
- :class:`CaptureSource`, :class:`AdcCaptureSource`: the driver's source
  protocol (``header``/``stream``/``fill_into``/``stop``) over it, packed
  voltages or int8 ADC frames.
- :func:`cor_send_matrix`, :func:`cor5c_send_matrix`: the C++ COR
  packetizers (custom 56-byte and Mark5C formats) to UDP or a file.
- :func:`transmit_gulp`, :func:`transmit_stream`: the snap2 blaster.

:class:`.source.UdpSnap2Source` is the pure-Python reassembler with the
same semantics, for tests and low rates.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from . import source as source_mod

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("capture.cpp", "xdp_capture.cpp", "transmit.cpp", "cor_writer.cpp")
HEADERS = ("cbd_native.h", "capture_impl.h")
#: ``native/Makefile``'s CXXFLAGS and link mode
CXXFLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-pthread",
            "-shared")
#: forced into every source (``-include``)
COMPAT = Path(__file__).resolve().with_name("native_compat.h")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_lib = None


def source_hash() -> str:
    """Hash of the flags, the sources and the headers."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for path in [NATIVE_DIR / name for name in SOURCES + HEADERS] + [COMPAT]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless one for these sources exists; returns
    its path.  Raises ``RuntimeError`` with the compiler's output if
    ``g++`` fails (``OSError`` if there is no ``g++``)."""
    so = BUILD_DIR / f"libcbd_native_{source_hash()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists():
            return so  # another process built it while this one waited
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXXFLAGS, "-include", str(COMPAT),
             "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for native/:\n{proc.stderr}")
        os.replace(tmp, so)
    return so


def load():
    """The configured library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _configure(ctypes.CDLL(str(build())))
    return _lib


def _configure(lib):
    lib.cbd_capture_create.restype = ctypes.c_void_p
    lib.cbd_capture_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
    lib.cbd_capture_create_xdp.restype = ctypes.c_void_p
    lib.cbd_capture_create_xdp.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int]
    lib.cbd_capture_start.restype = ctypes.c_int
    lib.cbd_capture_start.argtypes = [ctypes.c_void_p]
    lib.cbd_capture_get_gulp.restype = ctypes.c_int64
    lib.cbd_capture_get_gulp.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_uint8),
                                         ctypes.c_double]
    lib.cbd_capture_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.cbd_capture_xdp_sg.restype = ctypes.c_int
    lib.cbd_capture_xdp_sg.argtypes = [ctypes.c_void_p]
    lib.cbd_capture_stop.argtypes = [ctypes.c_void_p]
    lib.cbd_capture_destroy.argtypes = [ctypes.c_void_p]
    lib.cbd_transmit_gulp.restype = ctypes.c_int64
    lib.cbd_transmit_gulp.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_long, ctypes.c_int]
    lib.cbd_transmit_stream.restype = ctypes.c_int64
    lib.cbd_transmit_stream.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_long, ctypes.c_int]
    lib.cbd_cor_send_matrix.restype = ctypes.c_int64
    lib.cbd_cor_send_matrix.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_double,
        ctypes.c_double, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_double, ctypes.c_char_p]
    lib.cbd_cor5c_send_matrix.restype = ctypes.c_int64
    lib.cbd_cor5c_send_matrix.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint16,
        ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_double, ctypes.c_char_p]
    return lib


def available() -> bool:
    try:
        load()
        return True
    except (OSError, RuntimeError, AttributeError):
        return False


class NativeCapture:
    """High-rate snap2 capture (C++ RX thread + recvmmsg), the analog of
    the reference's UDPCapture/UDPVerbsCapture engines
    (capture_block.py:180-189)."""

    def __init__(self, cfg, bind_ip: str = "0.0.0.0", port: int = 10000,
                 nbuf: int = 8, xdp_ifname: str | None = None,
                 xdp_queue: int = 0):
        """``xdp_ifname`` selects the AF_XDP kernel-bypass front end: packets
        for ``port`` on that interface/queue bypass the kernel network
        stack.  Raises OSError when the socket or AF_XDP setup fails."""
        self.cfg = cfg
        self._h = None
        self._lib = load()
        if xdp_ifname is not None:
            self._h = self._lib.cbd_capture_create_xdp(
                xdp_ifname.encode(), xdp_queue, port, cfg.nchan,
                cfg.ninput, cfg.ntime_gulp, nbuf)
            if not self._h:
                raise OSError(
                    f"AF_XDP capture setup failed on {xdp_ifname} "
                    f"queue {xdp_queue} (kernel/caps/queue?)")
        else:
            self._h = self._lib.cbd_capture_create(
                bind_ip.encode(), port, cfg.nchan, cfg.ninput,
                cfg.ntime_gulp, nbuf)
            if not self._h:
                raise OSError(
                    f"failed to bind capture on {bind_ip}:{port}")
        # rotating destination buffers: get_gulp returns a view valid
        # until the same slot comes around again
        self._bufs = [np.zeros(cfg.gulp_nbyte, np.uint8)
                      for _ in range(4)]
        self._buf_i = 0

    def start(self):
        if self._lib.cbd_capture_start(self._h) != 0:
            raise RuntimeError("capture already started")

    @property
    def xdp_multibuffer(self) -> bool:
        """True when the AF_XDP front end bound with XDP_USE_SG (packets
        larger than one 4 KB UMEM chunk are reassembled from fragments);
        False for the recvmmsg engine or a single-buffer bind."""
        return bool(self._lib.cbd_capture_xdp_sg(self._h))

    def get_gulp(self, timeout_s: float = 5.0):
        """Returns (seq0, gulp [ntime, chan, input] view) or (None, None).
        The view stays valid for the next 3 get_gulp calls."""
        buf = self._bufs[self._buf_i]
        seq0 = self.get_gulp_into(buf, timeout_s)
        if seq0 is None:
            return None, None
        self._buf_i = (self._buf_i + 1) % len(self._bufs)
        cfg = self.cfg
        return seq0, buf.reshape(cfg.ntime_gulp, cfg.nchan, cfg.ninput)

    def get_gulp_into(self, dest: np.ndarray, timeout_s: float = 5.0):
        """Assemble the next gulp directly into ``dest`` (contiguous
        writable uint8 of gulp_nbyte bytes, e.g. a staging-ring
        reservation).  Returns seq0, or None on timeout."""
        # the engine writes gulp_nbyte linear bytes at the base pointer: a
        # strided, short or read-only buffer is refused, not asserted
        if dest.nbytes != self.cfg.gulp_nbyte:
            raise ValueError(f"dest is {dest.nbytes} B, need "
                             f"{self.cfg.gulp_nbyte}")
        if not dest.flags["C_CONTIGUOUS"] or not dest.flags["WRITEABLE"]:
            raise ValueError("dest must be C-contiguous and writable")
        seq0 = self._lib.cbd_capture_get_gulp(
            self._h, dest.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            timeout_s)
        return None if seq0 < 0 else int(seq0)

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.cbd_capture_stats(self._h, *[ctypes.byref(v)
                                               for v in vals])
        return {"ngood_bytes": vals[0].value, "npkt": vals[1].value,
                "nmissing": vals[2].value, "nseq": vals[3].value}

    def stop(self):
        self._lib.cbd_capture_stop(self._h)

    def close(self):
        if self._h:
            self._lib.cbd_capture_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class CaptureSource:
    """The driver's source protocol (``header``/``stream``/``fill_into``/
    ``stop``) over :class:`NativeCapture`.  ``stream(0)`` runs until
    :meth:`stop`; polls time out every ``poll_s`` so a stop is seen even
    with no traffic."""

    def __init__(self, cfg, bind_ip: str = "0.0.0.0", port: int = 10000,
                 nbuf: int = 16, poll_s: float = 2.0,
                 xdp_ifname: str | None = None, xdp_queue: int = 0):
        self.cfg = cfg
        self.capture = NativeCapture(cfg, bind_ip, port, nbuf=nbuf,
                                     xdp_ifname=xdp_ifname,
                                     xdp_queue=xdp_queue)
        self.capture.start()
        self.poll_s = poll_s
        self._stopped = False

    def header(self, **kw) -> dict:
        return source_mod.sequence_header(self.cfg, **kw)

    def stream(self, ngulp: int):
        n = 0
        while not self._stopped and (ngulp == 0 or n < ngulp):
            seq0, gulp = self.capture.get_gulp(timeout_s=self.poll_s)
            if seq0 is None:
                continue
            yield seq0, gulp
            n += 1

    def fill_into(self, dest: np.ndarray):
        """Assemble the next gulp straight into a staging reservation.
        Returns seq0, or None on a poll timeout or once stopped."""
        if self._stopped:
            return None
        return self.capture.get_gulp_into(dest, timeout_s=self.poll_s)

    def stats(self) -> dict:
        return self.capture.stats()

    def stop(self) -> None:
        self._stopped = True
        self.capture.stop()

    def close(self) -> None:
        self.stop()
        self.capture.close()


class AdcCaptureSource(CaptureSource):
    """FX-mode UDP ingest of raw int8 ADC frames over the snap2 wire
    format.  One snap2 "time" index is one frame of L = 2 nchan int8
    samples per input: the header's chan fields address sample chunks in
    the frame and its pol fields the inputs, so the capture engine runs
    with nchan -> L.  Frames per gulp = ``ntime_gulp``, so sequence numbers
    stay in output-spectra units.  int8 only, the digitizer width."""

    def __init__(self, cfg, bind_ip: str = "0.0.0.0", port: int = 10000,
                 nbuf: int = 16, poll_s: float = 2.0,
                 xdp_ifname: str | None = None, xdp_queue: int = 0):
        if cfg.adc_np_dtype != np.int8:
            raise ValueError("UDP ADC capture requires adc_dtype='int8'")
        self._fx_cfg = cfg
        super().__init__(cfg.replace(nchan=2 * cfg.nchan), bind_ip, port,
                         nbuf=nbuf, poll_s=poll_s, xdp_ifname=xdp_ifname,
                         xdp_queue=xdp_queue)

    def header(self, **kw) -> dict:
        h = source_mod.sequence_header(self._fx_cfg, **kw)
        h["nbit"] = 8
        h["adc"] = True
        return h

    def stream(self, ngulp: int):
        for seq0, gulp in super().stream(ngulp):
            yield seq0, gulp.view(np.int8)

    def fill_into(self, dest: np.ndarray):
        # defined beside stream() so the driver's zero-copy guard
        # (source_fill_compatible) takes this path; the driver views the
        # span as int8 itself
        return super().fill_into(dest)


def _int32_planes(vis_re, vis_im) -> tuple[np.ndarray, np.ndarray]:
    return (np.ascontiguousarray(vis_re, np.int32),
            np.ascontiguousarray(vis_im, np.int32))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def cor_send_matrix(vis_re: np.ndarray, vis_im: np.ndarray, nstand: int,
                    npol: int, sync_time: int, spectra_id: int,
                    bw_hz: float, sfreq_hz: float, acc_len: int,
                    chan0: int, dest_ip: str = "", port: int = 0,
                    max_mbps: float = -1.0,
                    dump_path: str | None = None) -> int:
    """Packetize the upper triangle of int32 planes [nchan, ninput,
    ninput] as custom 56-byte full-correlation packets in C++, one
    dual-pol baseline a packet, to (dest_ip, port) or appended to
    ``dump_path``.  Returns packets emitted."""
    lib = load()
    vis_re, vis_im = _int32_planes(vis_re, vis_im)
    sent = lib.cbd_cor_send_matrix(
        dest_ip.encode(), port, _i32p(vis_re), _i32p(vis_im),
        vis_re.shape[0], nstand, npol, sync_time, spectra_id, bw_hz,
        sfreq_hz, acc_len, chan0, max_mbps,
        dump_path.encode() if dump_path else None)
    if sent < 0:
        raise OSError("native COR send failed")
    return int(sent)


def cor5c_send_matrix(vis_re: np.ndarray, vis_im: np.ndarray, nstand: int,
                      npol: int, frame_number: int, secs_count: int,
                      freq_count: int, time_tag: int, navg: int,
                      dest_ip: str = "", port: int = 0,
                      max_mbps: float = -1.0,
                      dump_path: str | None = None) -> int:
    """The same in the production LWA-SV COR (Mark5C) format
    (corr_output_full_block.py:497-548); time_tag and navg in ADC samples,
    frame_number from :func:`.packets.cor_frame_number`."""
    lib = load()
    vis_re, vis_im = _int32_planes(vis_re, vis_im)
    sent = lib.cbd_cor5c_send_matrix(
        dest_ip.encode(), port, _i32p(vis_re), _i32p(vis_im),
        vis_re.shape[0], nstand, npol, frame_number, secs_count,
        freq_count, time_tag, navg, max_mbps,
        dump_path.encode() if dump_path else None)
    if sent < 0:
        raise OSError("native COR(Mark5C) send failed")
    return int(sent)


def _blast(fn, dest_ip: str, port: int, data: np.ndarray, seq0: int,
           extra: tuple, nchan_per_pkt, npol_per_pkt: int, delay_ns: int,
           miss_every: int) -> int:
    ntime, nchan, ninput = data.shape
    data = np.ascontiguousarray(data, np.uint8)
    sent = fn(dest_ip.encode(), port,
              data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ntime,
              nchan, ninput, seq0, *extra, nchan_per_pkt or nchan,
              npol_per_pkt, delay_ns, miss_every)
    if sent < 0:
        raise OSError("native transmit failed")
    return int(sent)


def transmit_gulp(dest_ip: str, port: int, data: np.ndarray, seq0: int,
                  nchan_per_pkt: int | None = None,
                  npol_per_pkt: int = 64, delay_ns: int = 0,
                  miss_every: int = 0) -> int:
    """Blast a [ntime, nchan, ninput] gulp as snap2 packets (the
    reference's test_tx_mt.c load generator); ``miss_every`` > 0 drops
    every such packet on purpose.  Returns packets sent."""
    return _blast(load().cbd_transmit_gulp, dest_ip, port, data, seq0, (),
                  nchan_per_pkt, npol_per_pkt, delay_ns, miss_every)


def transmit_stream(dest_ip: str, port: int, data: np.ndarray,
                    ngulp: int, seq0: int = 0,
                    nchan_per_pkt: int | None = None,
                    npol_per_pkt: int = 64, delay_ns: int = 0,
                    miss_every: int = 0) -> int:
    """Blast the same gulp ``ngulp`` times with advancing sequence
    numbers, all in C++: one socket and one absolute pacing deadline
    (``delay_ns`` every 16 x chan-block packets) for the whole stream."""
    return _blast(load().cbd_transmit_stream, dest_ip, port, data, seq0,
                  (ngulp,), nchan_per_pkt, npol_per_pkt, delay_ns,
                  miss_every)
