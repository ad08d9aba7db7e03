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

Beside the logs, a process-wide span recorder, off by default
(:func:`enable_spans`): the driver's threads and the sinks open
:func:`span` s around their work, stamped with ``time.time_ns()`` (the
clock ``torch.profiler``'s events carry, so spans and kernels share one
timeline), and :func:`spans_between` reads them back.  With spans off a
site costs one flag test.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque

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


# -- spans ------------------------------------------------------------------

_spans_on = False
_SPANS: deque = deque(maxlen=1 << 16)
_LOCAL = threading.local()


def enable_spans(on: bool = True) -> None:
    """Turn the span sites on or off, process-wide."""
    global _spans_on
    _spans_on = bool(on)


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class Span:
    """One open span: ``name``, ``start_ns`` and ``end_ns``
    (``time.time_ns()``), ``window``, the fast window the work serves
    (``seq0 // acc_len``; taken from the enclosing span where not given),
    and ``parent``, the name of the span that enclosed it on the same
    thread when it opened.  It opens when made, and :meth:`close` (or
    leaving its ``with``) records it; a span closed with ``record=False``
    can take its window later and be recorded by :meth:`record`.  The
    recorder keeps plain tuples, which the garbage collector stops
    tracking, so a full recorder does not bring on the interpreter's full
    collections."""

    __slots__ = ("name", "start_ns", "end_ns", "window", "parent")

    def __init__(self, name: str, window: int | None = None):
        stack = _stack()
        top = stack[-1] if stack else None
        if name.startswith("."):
            name = (top.name if top is not None else "") + name
        self.name = name
        self.parent = top.name if top is not None else None
        self.window = (top.window if window is None and top is not None
                       else window)
        self.end_ns = None
        stack.append(self)
        self.start_ns = time.time_ns()

    def close(self, record: bool = True) -> None:
        self.end_ns = time.time_ns()
        stack = _stack()
        if self in stack:
            # anything opened above it and left open closes unrecorded
            del stack[stack.index(self):]
        if record:
            self.record()

    def record(self) -> None:
        _SPANS.append((self.name, self.start_ns, self.end_ns, self.window,
                       self.parent))

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _NoSpan:
    """What :func:`span` gives with spans off: false, and does nothing
    (a ``window`` set on it is dropped)."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    window = property(lambda self: None, lambda self, w: None)

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def close(self, record: bool = True) -> None:
        pass

    def record(self) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, window: int | None = None):
    """A :class:`Span` to use in ``with``, or with spans off a shared
    false object that records nothing.  A ``name`` starting with "." is
    appended to the enclosing span's (``.throttle`` inside
    ``output.ibeam`` is ``output.ibeam.throttle``)."""
    if not _spans_on:
        return _NO_SPAN
    return Span(name, window)


def spans_between(t0_ns: int, t1_ns: int) -> list[tuple]:
    """(name, start_ns, end_ns, window, parent) of the recorded spans that
    started in [t0_ns, t1_ns), in the order they ended (the recorder keeps
    the last 65 536)."""
    # list() of a deque copies it whole while holding the GIL
    return [s for s in list(_SPANS) if t0_ns <= s[1] < t1_ns]


class PerfTimer:
    """Accumulates the acquire/reserve/process split for one stage.

    Per gulp: ``tick()`` at the start of the wait for input,
    ``mark_acquire()`` when it arrived, ``mark_reserve()`` when output
    space is held, ``mark_process(nbyte)`` when the work is done.

    With a ``stage`` name and spans on, each lap is also a span, named by
    the mark that ends it as its seconds are counted (``<stage>.acquire``,
    ``<stage>.reserve``, ``<stage>.process``) and open while it runs, so
    the spans the stage opens inside a lap are its children (their parent
    is the lap the marks so far say it will be); a mark's ``window`` is the
    fast window of the gulp it marks.
    """

    def __init__(self, perf_log: ProcLog | None = None,
                 stage: str | None = None):
        self.perf_log = perf_log
        self.stage = stage
        self.acquire_time = 0.0
        self.reserve_time = 0.0
        self.process_time = 0.0
        self.nbyte = 0
        self._prev = time.monotonic()
        self._open: Span | None = None   # the running lap's span

    def tick(self) -> None:
        """Start the wait for input again (the running lap is dropped)."""
        self._prev = time.monotonic()
        if self.stage is not None and (_spans_on or self._open):
            self._spans("", None, "acquire")

    def _lap(self) -> float:
        now = time.monotonic()
        dt = now - self._prev
        self._prev = now
        return dt

    def _spans(self, kind: str, window, nxt: str) -> None:
        """Record the running lap's span as ``<stage>.<kind>`` (dropped
        where ``kind`` is empty) and, with spans on, open the next, which
        the next mark is expected to end as ``nxt``."""
        sp = self._open
        if sp is not None:
            if kind:
                sp.name = f"{self.stage}.{kind}"
            if window is not None:
                sp.window = window
            sp.close(record=bool(kind))
        self._open = None
        if _spans_on:
            self._open = Span(f"{self.stage}.{nxt}",
                              None if nxt == "acquire" else window)

    def mark_acquire(self, window: int | None = None) -> None:
        self.acquire_time += self._lap()
        if self.stage is not None and (_spans_on or self._open):
            self._spans("acquire", window, "reserve")

    def mark_reserve(self, window: int | None = None) -> None:
        self.reserve_time += self._lap()
        if self.stage is not None and (_spans_on or self._open):
            self._spans("reserve", window, "process")

    def mark_process(self, nbyte: int = 0,
                     window: int | None = None) -> None:
        self.process_time += self._lap()
        self.nbyte += nbyte
        if self.stage is not None and (_spans_on or self._open):
            self._spans("process", window, "acquire")

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
