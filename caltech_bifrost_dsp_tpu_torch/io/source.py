"""Synthetic sources (port of ``caltech_bifrost_dsp_tpu/io/source.py::
DummySource`` and ``ADCSource``) with the interface the streaming driver
consumes: ``header()``, ``stream()`` and the zero-copy ``fill_into()``.

Modes follow the reference's DummySource (dummy_source_block.py):
``ramp`` (byte counter), ``random`` (``randint(0, 255)`` from a seeded
RandomState, drawn in call order) and ``testfile`` (loops a golden input
file in gulp-sized chunks, get_testfile_gulp:207); ``target_throughput``
caps emission in Gb/s (lines 275-283).  Each gulp is uint8 [ntime_gulp,
nchan, ninput], the capture-ring order.  The same seed gives the JAX
sources' bytes.
"""

from __future__ import annotations

import time

import numpy as np

from ..config import XEngineConfig

from ..verification import golden


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
                 target_throughput_gbps: float = 1000.0):
        if mode not in ("ramp", "random", "testfile"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
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
        the target throughput.  ``random`` draws in call order."""
        cfg = self.cfg
        shape = (cfg.ntime_gulp, cfg.nchan, cfg.ninput)
        if self.mode == "ramp":
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
        and return its first spectra index."""
        cfg = self.cfg
        out = dest.view(np.uint8).reshape(cfg.ntime_gulp, cfg.nchan,
                                          cfg.ninput)
        i = self._fill_i
        self._fill_i += 1
        if self.mode == "ramp":
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
