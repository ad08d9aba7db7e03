"""Synthetic gulp source (port of ``caltech_bifrost_dsp_tpu/io/source.py::
DummySource`` without its throughput throttle).

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
