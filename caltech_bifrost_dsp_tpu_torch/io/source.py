"""Sources (port of ``caltech_bifrost_dsp_tpu/io/source.py``): the synthetic
``SyntheticSource`` (the JAX ``DummySource``) and ``ADCSource`` with the
interface the streaming driver consumes, ``header()``, ``stream()`` and the
zero-copy ``fill_into()``, :class:`TriggerFileSource`, the replay of a
transient recorder file (:class:`.sink.TriggeredDump`), and
:class:`UdpSnap2Source`, the pure-Python snap2 reassembler (the native
engine is :mod:`.native`).

Modes follow the reference's DummySource (dummy_source_block.py):
``ramp`` (byte counter), ``random`` (``randint(0, 255)`` from a seeded
RandomState, drawn in call order) and ``testfile`` (loops a golden input
file in gulp-sized chunks, get_testfile_gulp:207); ``target_throughput``
caps emission in Gb/s (lines 275-283); ``skip_write`` emits zeros with no
generation cost, for benchmarking what lies downstream (lines 130-135).
Each gulp is uint8 [ntime_gulp, nchan, ninput], the capture-ring order.
The same seed gives the JAX sources' bytes.
"""

from __future__ import annotations

import json
import time
import weakref

import numpy as np

from ..config import XEngineConfig

from ..verification import golden
from . import packets as pk


def sequence_header(cfg: XEngineConfig, seq0: int, sync_time: int = 0,
                    time_tag: int = 1, chan0: int | None = None) -> dict:
    """The capture sequence header (capture_block.py:262-292)."""
    chan0 = cfg.chan0 if chan0 is None else chan0
    return {
        "time_tag": time_tag,
        "sync_time": sync_time,
        "seq0": seq0,
        "chan0": chan0,
        "nchan": cfg.nchan,
        "system_nchan": cfg.system_nchan,
        "fs_hz": cfg.fs_hz,
        "sfreq": chan0 * cfg.chan_bw_hz,
        "bw_hz": cfg.nchan * cfg.chan_bw_hz,
        "nstand": cfg.nstand,
        "pipeline_id": cfg.pipeline_id,
        "npol": cfg.npol,
        "complex": True,
        "nbit": 4,
    }


class SyntheticSource:
    def __init__(self, cfg: XEngineConfig, mode: str = "ramp",
                 testfile: str | None = None, seed: int = 0xdeadbeef,
                 target_throughput_gbps: float = 1000.0,
                 skip_write: bool = False):
        if mode not in ("ramp", "random", "testfile"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.skip_write = skip_write
        self.target_gbps = target_throughput_gbps
        self._rng = np.random.RandomState(seed)
        self._testdata = None
        self._test_ntime = 0
        if mode == "testfile":
            if testfile is None:
                raise ValueError("testfile mode needs a path")
            meta, data = golden.read_dat(testfile)
            ntime, nchan, nstand, npol = meta["shape"]
            if nchan < cfg.nchan or nstand < cfg.nstand:
                raise ValueError("test file smaller than configured system")
            self._testdata = data[:, :cfg.nchan, :cfg.nstand, :cfg.npol] \
                .reshape(ntime, cfg.nchan, cfg.nstand * cfg.npol)
            self._test_ntime = ntime
        self._emitted_bits = 0
        self._t_start = None
        self._fill_i = 0
        self._ramp = None
        # reservations known to hold only this source's zeros:
        # (id of the root buffer, address, size) -> weakref to that buffer
        self._zeroed_slots: dict = {}

    def header(self, seq0: int = 0, **kw) -> dict:
        return sequence_header(self.cfg, seq0, **kw)

    def _testfile_gulp(self, index: int) -> np.ndarray:
        g = self.cfg.ntime_gulp
        lo = (index * g) % self._test_ntime
        out = np.empty((g, self.cfg.nchan, self.cfg.ninput), np.uint8)
        done = 0
        while done < g:
            n = min(g - done, self._test_ntime - lo)
            out[done:done + n] = self._testdata[lo:lo + n]
            done += n
            lo = (lo + n) % self._test_ntime
        return out

    def gulp(self, index: int) -> np.ndarray:
        """Gulp ``index``: uint8 [ntime_gulp, nchan, ninput], throttled to
        the target throughput.  ``random`` draws in call order;
        ``skip_write`` gives zeros whatever the mode."""
        cfg = self.cfg
        shape = (cfg.ntime_gulp, cfg.nchan, cfg.ninput)
        if self.skip_write:
            data = np.zeros(shape, np.uint8)
        elif self.mode == "ramp":
            n = int(np.prod(shape))
            data = ((index * n + np.arange(n)) & 0xFF).astype(
                np.uint8).reshape(shape)
        elif self.mode == "testfile":
            data = self._testfile_gulp(index)
        else:
            data = self._rng.randint(0, 255, shape, dtype=np.uint8)
        self._throttle(data.nbytes)
        return data

    def _throttle(self, nbytes: int) -> None:
        now = time.monotonic()
        if self._t_start is None:
            self._t_start = now
        self._emitted_bits += 8 * nbytes
        sleep = (self._emitted_bits / (self.target_gbps * 1e9)
                 - (now - self._t_start))
        if sleep > 0:
            time.sleep(sleep)

    def fill_into(self, dest: np.ndarray) -> int:
        """Write the next gulp into ``dest`` (a staging-ring reservation)
        and return its first spectra index.  ``skip_write`` writes zeros
        once per reservation and skips even that when a recycled one is
        known to hold only this source's zeros."""
        cfg = self.cfg
        out = dest.view(np.uint8).reshape(cfg.ntime_gulp, cfg.nchan,
                                          cfg.ninput)
        i = self._fill_i
        self._fill_i += 1
        if self.skip_write:
            # the key holds the root buffer, not only an address: a ring
            # rebuilt at a recycled address holds garbage.  The weakref
            # pins the buffer's id for as long as the entry lives.
            base = dest
            while base.base is not None:
                base = base.base
            key = (id(base), dest.__array_interface__["data"][0],
                   dest.nbytes)
            ref = self._zeroed_slots.get(key)
            if ref is None or ref() is not base:
                out[...] = 0
                self._zeroed_slots[key] = weakref.ref(base)
        elif self.mode == "ramp":
            flat = out.reshape(-1)
            if self._ramp is None or self._ramp.size != flat.size:
                self._ramp = (np.arange(flat.size) & 0xFF).astype(np.uint8)
            # uint8 wraparound add == (start + arange) & 0xFF
            np.add(self._ramp, np.uint8((i * flat.size) & 0xFF), out=flat)
        elif self.mode == "testfile":
            out[...] = self._testfile_gulp(i)
        else:
            out[...] = self._rng.randint(0, 255, out.shape, dtype=np.uint8)
        self._throttle(out.nbytes)
        return i * cfg.ntime_gulp

    def stream(self, ngulp: int, seq0: int = 0):
        """Yield ``(t, gulp)`` with t the gulp's first spectra index;
        ``ngulp == 0`` runs forever."""
        i = 0
        while ngulp == 0 or i < ngulp:
            yield seq0 + i * self.cfg.ntime_gulp, self.gulp(i)
            i += 1


class ADCSource:
    """Raw ADC sample generator for the FX (channelizer-included) mode.

    Emits gulps of ``ntime_gulp * 2 * nchan`` ADC samples, [nsamp,
    ninput], in ``cfg.adc_dtype`` (float32, or int8 where the signal is
    rounded to integer counts and clipped to [-127, 127]).  Modes:
    ``noise`` (``standard_normal * amplitude`` from a seeded RandomState,
    drawn in call order) or ``tone``, a cosine in channel ``tone_chan`` on
    every input.  The same seed gives the JAX ``ADCSource``'s bytes.
    """

    def __init__(self, cfg: XEngineConfig, mode: str = "noise",
                 tone_chan: int = 5, amplitude: float = 4.0,
                 seed: int = 0xF00D):
        if mode not in ("noise", "tone"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.tone_chan = tone_chan
        self.amplitude = amplitude
        self.dtype = cfg.adc_np_dtype
        self._rng = np.random.RandomState(seed)
        self.samples_per_gulp = cfg.ntime_gulp * 2 * cfg.nchan
        self._fill_i = 0

    def header(self, seq0: int = 0, **kw) -> dict:
        h = sequence_header(self.cfg, seq0, **kw)
        h["nbit"] = 8 * self.dtype.itemsize
        h["adc"] = True
        h["complex"] = False  # raw ADC samples are real
        return h

    def _cast(self, x: np.ndarray) -> np.ndarray:
        if self.dtype == np.int8:
            return np.clip(np.rint(x), -127, 127).astype(np.int8)
        return x.astype(np.float32)

    def gulp(self, index: int) -> np.ndarray:
        """ADC gulp ``index``: [ntime_gulp * 2 * nchan, ninput]."""
        cfg = self.cfg
        n = self.samples_per_gulp
        if self.mode == "tone":
            t = np.arange(index * n, (index + 1) * n, dtype=np.float64)
            x = self.amplitude * np.cos(
                2 * np.pi * self.tone_chan / (2 * cfg.nchan) * t)
            return np.ascontiguousarray(np.broadcast_to(
                self._cast(x)[:, None], (n, cfg.ninput)))
        return self._cast(self._rng.standard_normal([n, cfg.ninput])
                          * self.amplitude)

    def stream(self, ngulp: int, seq0: int = 0):
        """Yield ``(t, gulp)``; ``ngulp == 0`` runs forever."""
        i = 0
        while ngulp == 0 or i < ngulp:
            yield seq0 + i * self.cfg.ntime_gulp, self.gulp(i)
            i += 1

    def fill_into(self, dest: np.ndarray) -> int:
        """Write the next ADC gulp into a staging reservation (see
        :meth:`SyntheticSource.fill_into`)."""
        out = dest.view(self.dtype).reshape(self.samples_per_gulp,
                                            self.cfg.ninput)
        i = self._fill_i
        self._fill_i += 1
        out[...] = self.gulp(i)
        return i * self.cfg.ntime_gulp


class TriggerFileSource:
    """Replay a :class:`.sink.TriggeredDump` file as a sequence (reference:
    blocks/trigger_source_block.py:73 TriggerReplay).

    The file (triggered_dump_block.py:131-151): an 8-byte little-endian
    total-size prefix, the JSON header padded to 1 MB, then the raw ring
    frames: packed uint8 [ntime, nchan, ninput], or with ``adc`` in the
    header ADC samples [ntime, ninput] of ``nbit`` bits.
    """

    HEADER_BLOCK = 1024 * 1024

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            size = int.from_bytes(fh.read(8), "little")
            raw = fh.read(self.HEADER_BLOCK - 8)
            self.header = json.loads(raw.split(b"\x00", 1)[0].decode())
            self.payload_nbyte = size - self.HEADER_BLOCK

    def read(self) -> tuple[dict, np.ndarray]:
        """(header, samples): uint8 [ntime, nchan, ninput], or in the ADC
        layout int8/float32 [ntime, ninput]."""
        with open(self.path, "rb") as fh:
            fh.seek(self.HEADER_BLOCK)
            raw = fh.read(self.payload_nbyte)
        h = self.header
        if h.get("adc"):
            adc_dt = np.int8 if h.get("nbit", 32) == 8 else np.float32
            data = np.frombuffer(raw, adc_dt)
            return h, data.reshape(h["ntime"], h["nstand"] * h["npol"])
        data = np.frombuffer(raw, np.uint8)
        shape = (h["ntime"], h["nchan"], h["nstand"] * h["npol"])
        return h, data.reshape(shape)

    def gulps(self, ntime_gulp: int):
        """Yield ``(t, gulp)`` of ``ntime_gulp`` rows each from the header's
        ``seq0`` on; a short tail is left out."""
        h, data = self.read()
        seq0 = h.get("seq0", 0)
        for g in range(data.shape[0] // ntime_gulp):
            yield (seq0 + g * ntime_gulp,
                   data[g * ntime_gulp:(g + 1) * ntime_gulp])


class UdpSnap2Source:
    """Socket-based snap2 packet capture reassembling gulps: the
    pure-Python counterpart of the native engine (:mod:`.native`), for tests
    and low rates.  Packets for the same ``seq`` land at [time, chan block,
    pol block] of the gulp that owns them."""

    _MAX_PENDING_GULPS = 4  # stash window for early next-gulp packets

    def __init__(self, cfg: XEngineConfig, sock,
                 ntime_gulp: int | None = None, timeout_s: float = 5.0):
        self.cfg = cfg
        self.sock = sock
        self.ntime_gulp = ntime_gulp or cfg.ntime_gulp
        self.timeout_s = timeout_s
        sock.settimeout(timeout_s)
        self._pending: dict[int, np.ndarray] = {}
        self._filled: dict[int, set] = {}  # landing keys of stashed gulps
        self._expected = None  # packets per gulp, from the first header
        self.ngood_bytes = 0
        self.nmissing = 0

    def capture_gulp(self, seq_start: int) -> np.ndarray:
        """Blocking: assemble the gulp covering [seq_start, seq_start + g).
        Missing packets stay zero and are counted in ``nmissing``.

        Packets of later gulps drained meanwhile are stashed (up to
        ``_MAX_PENDING_GULPS`` ahead) and land when their gulp is asked
        for; a duplicate datagram lands once (landing sets, not counts)."""
        cfg = self.cfg
        g = self.ntime_gulp
        # drop stashes the caller skipped past
        for k in [k for k in self._pending if k < seq_start]:
            self._pending.pop(k, None)
            self._filled.pop(k, None)
        buf = self._pending.pop(seq_start, None)
        landed = self._filled.pop(seq_start, None) or set()
        if buf is None:
            buf = np.zeros((g, cfg.nchan, cfg.ninput), np.uint8)
        expected = self._expected
        deadline = time.monotonic() + self.timeout_s
        while time.monotonic() < deadline:
            if expected is not None and len(landed) >= expected:
                break
            try:
                pkt = self.sock.recv(65536)
            except OSError:
                break
            hdr, payload = pk.decode_snap2(pkt)
            if expected is None:
                npkt_per_time = ((cfg.nchan // hdr.nchan)
                                 * (cfg.ninput // hdr.npol))
                expected = self._expected = npkt_per_time * g
            t = hdr.seq - seq_start
            if t < 0:
                continue  # stale packet of an emitted gulp
            c0 = hdr.chan_block_id * hdr.nchan
            # the key is relative to the packet's own gulp (t % g), so a
            # stashed key matches the one the region gets when that gulp
            # becomes current
            key = (int(t % g), int(c0), int(hdr.pol0))
            if t >= g:  # a packet of a later gulp: stash it
                if t >= g * (self._MAX_PENDING_GULPS + 1):
                    continue
                base = seq_start + (t // g) * g
                pend = self._pending.get(base)
                if pend is None:
                    pend = self._pending[base] = np.zeros_like(buf)
                    self._filled[base] = set()
                if key in self._filled[base]:
                    continue  # duplicate
                self._filled[base].add(key)
                pend[t - (base - seq_start), c0:c0 + hdr.nchan,
                     hdr.pol0:hdr.pol0 + hdr.npol] = payload
                self.ngood_bytes += payload.nbytes
                continue
            if key in landed:
                continue  # duplicate
            landed.add(key)
            buf[t, c0:c0 + hdr.nchan,
                hdr.pol0:hdr.pol0 + hdr.npol] = payload
            self.ngood_bytes += payload.nbytes
        if expected is not None and len(landed) < expected:
            self.nmissing += expected - len(landed)
        return buf
