"""Synthetic sources (port of ``caltech_bifrost_dsp_tpu/io/source.py::
DummySource`` without its throughput throttle, and ``ADCSource``).

Modes follow the reference's DummySource (dummy_source_block.py):
``ramp`` (byte counter), ``random`` (``randint(0, 255)`` from a seeded
RandomState) and ``testfile`` (loops a golden input file in gulp-sized
chunks, get_testfile_gulp:207).  Each gulp is uint8 [ntime_gulp, nchan,
ninput], the capture-ring order.
"""

from __future__ import annotations

import numpy as np

from caltech_bifrost_dsp_tpu.config import XEngineConfig

from ..verification import golden


class SyntheticSource:
    def __init__(self, cfg: XEngineConfig, mode: str = "ramp",
                 testfile: str | None = None, seed: int = 0xdeadbeef):
        if mode not in ("ramp", "random", "testfile"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
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
        """Gulp ``index``: uint8 [ntime_gulp, nchan, ninput].  ``random``
        draws from the stream in call order."""
        cfg = self.cfg
        shape = (cfg.ntime_gulp, cfg.nchan, cfg.ninput)
        if self.mode == "ramp":
            n = int(np.prod(shape))
            return ((index * n + np.arange(n)) & 0xFF).astype(
                np.uint8).reshape(shape)
        if self.mode == "testfile":
            return self._testfile_gulp(index)
        return self._rng.randint(0, 255, shape, dtype=np.uint8)

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
