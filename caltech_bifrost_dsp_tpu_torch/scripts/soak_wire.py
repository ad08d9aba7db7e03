"""Loopback wire processes: the snap2 blaster and the ``recvmmsg``
receiver binding that the soak (:mod:`.soak`) and ``chip_smoke.py`` share.

The blaster and each receiver run in a process of its own, so that none
shares the driver's interpreter lock.  The receivers read with
``recvmmsg`` through ctypes: a Python ``recv`` loop loses datagrams over a
gVisor host's loopback at rates it keeps up with on average.
"""

from __future__ import annotations

import ctypes
import socket
import struct
import time
from multiprocessing import shared_memory

import numpy as np

from ..io import native
from ..io import packets as pk

#: datagrams a ``recvmmsg`` call takes at most, and their largest size
BATCH = 512
DATAGRAM = 16384
#: the receive timeout after which a ``recvmmsg`` call returns what it has
RECV_TIMEOUT_S = 0.1


def stream_seq(k: int, n_a: int, gap_gulps: int) -> int:
    """Gulp index (sequence number / ntime_gulp) of the ``k``-th gulp sent:
    segment A counts from 0, segment B resumes ``gap_gulps`` further on."""
    return k if k < n_a else k + gap_gulps


def blast(conn, shm_name: str, shape: tuple, port: int, nchan_per_pkt: int,
          npol_per_pkt: int, delay_ns: int, rate: float | None, n_a: int,
          n_b: int = 0, gap_gulps: int = 0, sent=None) -> None:
    """Send ``n_a + n_b`` gulps as snap2 packets to 127.0.0.1:``port``.

    ``shape`` is [nframe, ntime_gulp, nchan, ninput] of the uint8 frames in
    the shared memory ``shm_name``; the ``k``-th gulp sent is frame ``k %
    nframe`` at sequence number ``stream_seq(k) * ntime_gulp``, and leaves
    at ``k / rate`` seconds after "go" arrives on ``conn`` (``rate`` None:
    back to back; ``delay_ns`` paces the packets within a gulp, every 16
    time samples).  Two more gulps follow the last, which releases it from
    the capture.  ``sent`` (a shared integer, optional) counts the gulps
    sent; a message on ``conn`` stops the blaster early.  Sends back
    (packets sent, seconds of sending)."""
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        frames = np.ndarray(shape, np.uint8, buffer=shm.buf)
        nframe, ntime_gulp = shape[0], shape[1]
        native.load()
        conn.send("ready")
        conn.recv()
        npkt, t0 = 0, time.monotonic()
        for k in range(n_a + n_b + 2):
            if conn.poll():
                break
            if rate is not None:
                time.sleep(max(0.0, t0 + k / rate - time.monotonic()))
            npkt += native.transmit_gulp(
                "127.0.0.1", port, frames[k % nframe],
                seq0=stream_seq(k, n_a, gap_gulps) * ntime_gulp,
                nchan_per_pkt=nchan_per_pkt, npol_per_pkt=npol_per_pkt,
                delay_ns=delay_ns)
            if sent is not None:
                sent.value = k + 1
        conn.send((npkt, time.monotonic() - t0))
        del frames
    finally:
        shm.close()


class _IoVec(ctypes.Structure):
    _fields_ = [("base", ctypes.c_void_p), ("len", ctypes.c_size_t)]


class _MsgHdr(ctypes.Structure):
    _fields_ = [("name", ctypes.c_void_p), ("namelen", ctypes.c_uint32),
                ("iov", ctypes.POINTER(_IoVec)), ("iovlen", ctypes.c_size_t),
                ("control", ctypes.c_void_p), ("controllen", ctypes.c_size_t),
                ("flags", ctypes.c_int)]


class _MMsgHdr(ctypes.Structure):
    _fields_ = [("hdr", _MsgHdr), ("len", ctypes.c_uint)]


def bind_loopback(timeout_s: float) -> socket.socket:
    """A loopback UDP socket on a free port with as large a receive buffer
    as the host grants and a receive timeout of ``timeout_s``."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    want = 1 << 30
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUFFORCE, want)
    except (AttributeError, PermissionError, OSError):
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, want)
    sock.bind(("127.0.0.1", 0))
    set_timeout(sock, timeout_s)
    return sock


def set_timeout(sock: socket.socket, seconds: float) -> None:
    """The kernel's receive timeout, after which ``recvmmsg`` returns what
    it has (or -1)."""
    usec = int(seconds * 1e6)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO,
                    struct.pack("ll", usec // 1_000_000, usec % 1_000_000))


class MMsgVec:
    """``n`` ``recvmmsg`` message headers over consecutive ``size``-byte
    slots from the address ``base`` (which the caller keeps alive)."""

    def __init__(self, base: int, n: int, size: int):
        self.base, self.size = base, size
        self.iovs = (_IoVec * n)()
        self.msgs = (_MMsgHdr * n)()
        for k in range(n):
            self.iovs[k].base, self.iovs[k].len = base + k * size, size
            self.msgs[k].hdr.iov = ctypes.pointer(self.iovs[k])
            self.msgs[k].hdr.iovlen = 1
        self._libc = ctypes.CDLL(None, use_errno=True)
        self._libc.recvmmsg.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_uint, ctypes.c_int,
                                        ctypes.c_void_p]

    def recv(self, sock: socket.socket, first: int, count: int) -> int:
        """One ``recvmmsg`` into slots ``first`` on, at most ``count``;
        returns the datagrams read, <= 0 when the timeout passed first."""
        return self._libc.recvmmsg(
            sock.fileno(), ctypes.addressof(self.msgs)
            + first * ctypes.sizeof(_MMsgHdr), count, 0, None)

    def length(self, k: int) -> int:
        return self.msgs[k].len

    def datagram(self, k: int) -> bytes | None:
        """Slot ``k``'s datagram, None where it did not fit the slot."""
        n = self.msgs[k].len
        if n > self.size or self.msgs[k].hdr.flags & socket.MSG_TRUNC:
            return None
        return ctypes.string_at(self.base + k * self.size, n)


class SubselTruth:
    """Checks CorrPart packets against one subselection truth: int32
    ``re``, ``im`` [nchan_out, nvis] and the ``baselines`` [nvis, 2, 2] they
    select; a packet's first baseline says where its visibilities start."""

    def __init__(self, re: np.ndarray, im: np.ndarray, baselines):
        self.re, self.im = re, im
        bl = np.asarray(baselines, np.uint32)
        self.start = {bl[v].tobytes(): v for v in range(len(bl) - 1, -1, -1)}

    def packet_ok(self, pkt: bytes) -> bool:
        hdr, bl, data = pk.decode_corr_part(pkt)
        v0 = self.start.get(np.asarray(bl[0], np.uint32).tobytes())
        if v0 is None or data.shape[1] != self.re.shape[0]:
            return False
        v1 = v0 + hdr.nvis
        return bool(np.array_equal(data[..., 0], self.re[:, v0:v1].T)
                    and np.array_equal(data[..., 1], self.im[:, v0:v1].T))


def _spectra_id(kind: str, pkt: bytes) -> int | None:
    if kind == "corr":
        return pk.decode_corr_full(pkt)[0].spectra_id
    if kind == "part":
        return pk.decode_corr_part(pkt)[0].spectra_id
    return None


def receive(conn, kind: str, truth: SubselTruth | None = None) -> None:
    """Count the datagrams of one product stream until told to stop.

    Reports (port, receive buffer bytes) on ``conn``, then reads batches
    with ``recvmmsg``.  Per window (spectra id, for the ``corr`` and
    ``part`` streams) it counts packets, and with ``truth`` the ``part``
    packets that differ from it.  After a message on ``conn`` it drains
    the socket and sends back a summary: packets, bytes, the monotonic
    clock of the first and the last arrival, the last datagram, and the
    per-window counts."""
    sock = bind_loopback(RECV_TIMEOUT_S)
    buf = ctypes.create_string_buffer(BATCH * DATAGRAM)
    msgs = MMsgVec(ctypes.addressof(buf), BATCH, DATAGRAM)
    conn.send((sock.getsockname()[1],
               sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)))
    out = {"packets": 0, "bytes": 0, "first_t": None, "last_t": None,
           "last_pkt": b"", "windows": {}, "bad": {}, "truncated": 0}
    stopping = False
    while True:
        n = msgs.recv(sock, 0, BATCH)
        if n <= 0:
            if stopping:
                break
            stopping = conn.poll()
            continue
        now = time.monotonic()
        if out["first_t"] is None:
            out["first_t"] = now
        out["last_t"] = now
        out["packets"] += n
        for k in range(n):
            out["bytes"] += msgs.length(k)
            pkt = msgs.datagram(k)
            if pkt is None:
                out["truncated"] += 1
                continue
            sid = _spectra_id(kind, pkt)
            if sid is not None:
                out["windows"][sid] = out["windows"].get(sid, 0) + 1
                if truth is not None and not truth.packet_ok(pkt):
                    out["bad"][sid] = out["bad"].get(sid, 0) + 1
        out["last_pkt"] = ctypes.string_at(
            msgs.base + (n - 1) * DATAGRAM, min(msgs.length(n - 1), DATAGRAM))
        if not stopping:
            stopping = conn.poll()
    sock.close()
    conn.send(out)
