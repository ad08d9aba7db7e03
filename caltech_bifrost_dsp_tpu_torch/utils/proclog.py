"""Per-stage performance accounting (port of
``caltech_bifrost_dsp_tpu/utils/proclog.py``).

The reference instruments every block with the acquire / reserve / process
time split plus a gbps gauge, published through file-backed ProcLogs and
bridged to etcd (reference: blocks/block_base.py:112-119,
blocks/corr_block.py:453-457).  The same taxonomy is kept: ``acquire`` is
time spent waiting for input, ``reserve`` time waiting for output space,
``process`` time computing.  Logs are in-memory dicts in one process-wide
registry, optionally mirrored to files, and exported through the control
store by :mod:`..control.monitor`.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

#: File-mirror root (the analog of /dev/shm/bifrost/<pid>).
PROCLOG_ROOT = os.environ.get(
    "CBD_TPU_PROCLOG_ROOT",
    os.path.join(tempfile.gettempdir(), "cbd_torch", str(os.getpid())))

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: dict[str, "ProcLog"] = {}


class ProcLog:
    """A named key/value log; ``update`` replaces the contents."""

    def __init__(self, name: str, mirror_to_disk: bool = False):
        self.name = name
        self.data: dict = {}
        self._mirror = mirror_to_disk
        self._lock = threading.Lock()
        with _REGISTRY_LOCK:
            _REGISTRY[name] = self

    def update(self, contents: dict) -> None:
        with self._lock:
            self.data = dict(contents)
            if self._mirror:
                path = os.path.join(PROCLOG_ROOT, *self.name.split("/"))
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = path + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(self.data, fh)
                os.replace(tmp, path)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.data)


def registry_snapshot() -> dict[str, dict]:
    """All live proclogs, for the monitoring bridge."""
    with _REGISTRY_LOCK:
        logs = list(_REGISTRY.items())
    return {name: log.snapshot() for name, log in logs}


def clear_registry() -> None:
    """Drop all registered proclogs (tests, fresh pipelines)."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()


class PerfTimer:
    """Accumulates the acquire/reserve/process split for one stage.

    Per gulp: ``tick()`` at the start of the wait for input,
    ``mark_acquire()`` when it arrived, ``mark_reserve()`` when output
    space is held, ``mark_process(nbyte)`` when the work is done.
    """

    def __init__(self, perf_log: ProcLog | None = None):
        self.perf_log = perf_log
        self.acquire_time = 0.0
        self.reserve_time = 0.0
        self.process_time = 0.0
        self.nbyte = 0
        self._prev = time.monotonic()

    def tick(self) -> None:
        self._prev = time.monotonic()

    def _lap(self) -> float:
        now = time.monotonic()
        dt = now - self._prev
        self._prev = now
        return dt

    def mark_acquire(self) -> None:
        self.acquire_time += self._lap()

    def mark_reserve(self) -> None:
        self.reserve_time += self._lap()

    def mark_process(self, nbyte: int = 0) -> None:
        self.process_time += self._lap()
        self.nbyte += nbyte

    @property
    def gbps(self) -> float:
        if self.process_time <= 0:
            return 0.0
        return 8 * self.nbyte / self.process_time / 1e9

    def publish(self) -> dict:
        rec = {"acquire_time": self.acquire_time,
               "reserve_time": self.reserve_time,
               "process_time": self.process_time,
               "gbps": self.gbps}
        if self.perf_log is not None:
            self.perf_log.update(rec)
        return rec

    def reset(self) -> None:
        self.acquire_time = self.reserve_time = self.process_time = 0.0
        self.nbyte = 0
        self.tick()
