"""The harness's load generator: a seeded pool of gulps cycling in a
closed loop, in the port's source interface (``header``, ``stream``,
``fill_into``, ``stop``).

The pool is drawn on the card from ``--seed`` in one call per gulp
(packed 4+4-bit bytes, or int8 ADC noise) and held on the host.  Gulp
``n`` of the stream is pool gulp ``n % npool``.  The traffic file fixes
the pool at as many gulps as the driver's staging ring holds (15 at
LWA-352 shapes: three windows of five distinct gulps; the harness refuses
a ring of another size), so reservations come back to the source in the
pool's order, and a reservation that already holds its gulp is not
written again: after the ring's first cycle the source writes nothing,
like the upstream's ``skip_write`` throughput source
(dummy_source_block.py:130-140), and is never the limit.  The ring
writes a capture makes are therefore not in these cells' measurement.
:meth:`PoolSource.check_written_once` refuses a run in which the source
wrote a slot twice.  The loop is closed: the ring sets the pace.
``stop()`` (the driver's ``shutdown``) ends the stream.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch


def make_pool(n: int, shape: tuple, kind: str, seed: int, device,
              amplitude: float = 0.0) -> list[np.ndarray]:
    """``n`` host gulps drawn from ``seed`` on ``device``: ``kind``
    "packed" gives uniform uint8 bytes of ``shape``; "adc_int8" gives
    rint(N(0, 1) * amplitude) clipped to [-127, 127] as int8."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    pool = []
    for _ in range(n):
        if kind == "packed":
            g = torch.randint(0, 256, shape, generator=gen, device=device,
                              dtype=torch.uint8)
        elif kind == "adc_int8":
            g = torch.randn(shape, generator=gen, device=device)
            g = g.mul_(amplitude).round_().clamp_(-127, 127).to(torch.int8)
        else:
            raise ValueError(f"unknown pool kind {kind!r}")
        pool.append(g.cpu().numpy())
        del g
    return pool


def capture_header(cfg, seq0: int, sync_time: int = 0, time_tag: int = 1,
                   adc: bool = False) -> dict:
    """The capture sequence header the driver reads (the reference's
    capture_block.py:262-292 fields)."""
    chan0 = cfg.pipeline_id * cfg.nchan
    h = {"time_tag": time_tag, "sync_time": sync_time, "seq0": seq0,
         "chan0": chan0, "nchan": cfg.nchan,
         "system_nchan": cfg.nchan * cfg.npipeline, "fs_hz": cfg.fs_hz,
         "sfreq": chan0 * cfg.chan_bw_hz,
         "bw_hz": cfg.nchan * cfg.chan_bw_hz, "nstand": cfg.nstand,
         "pipeline_id": cfg.pipeline_id, "npol": cfg.npol,
         "complex": True, "nbit": 4}
    if adc:
        h.update(adc=True, complex=False, nbit=8)
    return h


class PoolSource:
    """Closed-loop source over ``pool`` (host gulps of the ring's shape)."""

    def __init__(self, cfg, pool: list[np.ndarray], adc: bool = False):
        self.cfg = cfg
        self.pool = pool
        self.adc = adc
        self.nfilled = 0
        self.nwritten = 0
        self._stopped = False
        # reservation (root buffer id, address) -> (weakref to the root
        # buffer, pool index it holds)
        self._held: dict = {}

    def header(self, seq0: int = 0, sync_time: int = 0, **kw) -> dict:
        return capture_header(self.cfg, seq0, sync_time, adc=self.adc)

    def fill_into(self, dest: np.ndarray) -> int | None:
        """Copy the next pool gulp into a staging reservation; returns its
        first spectrum, or None once stopped."""
        if self._stopped:
            return None
        i = self.nfilled
        k = i % len(self.pool)
        root = dest
        while root.base is not None:
            root = root.base
        key = (id(root), dest.__array_interface__["data"][0])
        held = self._held.get(key)
        if held is None or held[0]() is not root or held[1] != k:
            src = self.pool[k]
            np.copyto(dest.view(src.dtype).reshape(src.shape), src)
            self._held[key] = (weakref.ref(root), k)
            self.nwritten += 1
        self.nfilled += 1
        return i * self.cfg.ntime_gulp

    def check_written_once(self) -> None:
        """Raise where the source wrote more gulps than the pool holds: the
        ring did not hand each slot back holding its gulp, so copies the
        traffic leaves out would be in the measurement."""
        if self.nwritten > len(self.pool):
            raise RuntimeError(
                f"the source wrote {self.nwritten} gulps into the staging "
                f"ring for a pool of {len(self.pool)}: the ring's slots do "
                f"not come back in the pool's order")

    def stream(self, ngulp: int, seq0: int = 0):
        """Yield ``(t, gulp)``; ``ngulp == 0`` runs until stopped."""
        i = 0
        while (ngulp == 0 or i < ngulp) and not self._stopped:
            yield seq0 + i * self.cfg.ntime_gulp, self.pool[i % len(self.pool)]
            i += 1

    def stop(self) -> None:
        self._stopped = True
