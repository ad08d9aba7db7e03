"""Device activity of a profiled slice of the measured window, read from
``torch.profiler``'s CUDA activity (kernels, copies and sets), and the
harness's own host spans that name the device's idle gaps.

Timestamps are Unix nanoseconds: the profiler's events carry them, and the
harness stamps its spans with ``time.time_ns()``.
"""

from __future__ import annotations

import re
from collections import defaultdict

_COPY = re.compile(r"^(Memcpy|Memset)")
_NAME = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*(<[^()]*>)?\s*\(")


def short_name(name: str) -> str:
    """A kernel's function name without namespaces, arguments or return
    type: ``void (anonymous namespace)::corr_acc_kernel<false, true>(...)``
    -> ``corr_acc_kernel<false, true>``."""
    if _COPY.match(name):
        return name
    m = _NAME.search(name.split("(anonymous namespace)::")[-1])
    if m is None:
        return name[:64]
    return (m.group(1) + (m.group(2) or ""))[:64]


def _union(intervals: list, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) covered by the union of ``intervals``."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


class Trace:
    """Kernels and copies (name, start_ns, end_ns) of the slice
    [t0_ns, t1_ns), and the fast windows stepped in it, by the
    ``contexts`` CUDA contexts (processes) that shared the card."""

    def __init__(self, ops: list, t0_ns: int, t1_ns: int, windows: int,
                 contexts: int = 1):
        self.t0_ns, self.t1_ns, self.windows = t0_ns, t1_ns, windows
        self.contexts = contexts
        inside = [o for o in ops if t0_ns <= o[1] < t1_ns]
        self.kernels = [o for o in inside if not _COPY.match(o[0])]
        self.copies = [o for o in inside if _COPY.match(o[0])]

    @classmethod
    def from_profiler(cls, prof, t0_ns: int, t1_ns: int, windows: int
                      ) -> "Trace":
        ops = []
        for e in prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()) or e.is_user_annotation():
                continue
            ops.append((e.name(), e.start_ns(), e.end_ns()))
        return cls(ops, t0_ns, t1_ns, windows)

    @classmethod
    def merged(cls, traces: list, windows: int) -> "Trace":
        """One trace of the card from the traces of the processes that
        share it: their kernels and copies over the slice every one of
        them profiled, and the ``windows`` they stepped in that slice."""
        ops = [o for t in traces for o in t.kernels + t.copies]
        return cls(ops, max(t.t0_ns for t in traces),
                   min(t.t1_ns for t in traces), windows, len(traces))

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds of the slice in which a kernel or copy ran."""
        iv = [(a, b) for _, a, b in self.kernels + self.copies]
        return _union(iv, self.t0_ns, self.t1_ns) / 1e9

    def kernel_s(self, patterns=None) -> float:
        """Summed seconds of the kernels whose names match one of the
        regular expressions ``patterns`` (all kernels when None).  Where
        several contexts shared the card, the seconds their intervals
        cover: the card time-slices between contexts, so a kernel's span
        takes in the other context's turns, and a sum would count that
        wall time once for each."""
        pats = [re.compile(p) for p in patterns or ()]
        iv = [(a, b) for n, a, b in self.kernels
              if not pats or any(p.search(n) for p in pats)]
        if self.contexts > 1:
            return _union(iv, self.t0_ns, self.t1_ns) / 1e9
        return sum(b - a for a, b in iv) / 1e9

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most (of
        several contexts, the wall time each name's spans cover, as
        :meth:`kernel_s` counts it)."""
        iv: dict = defaultdict(list)
        for name, a, b in self.kernels + self.copies:
            iv[short_name(name)].append((a, b))
        if self.contexts > 1:
            tot = {k: _union(v, self.t0_ns, self.t1_ns)
                   for k, v in iv.items()}
        else:
            tot = {k: sum(b - a for a, b in v) for k, v in iv.items()}
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, spans: list, n: int = 10) -> list:
        """[[label, seconds]] of the ``n`` longest stretches with nothing
        on the device, each named by the host span (label, start_ns,
        end_ns) that cover at least half of it ("a|b" where several do),
        else the one that covers most, else "host"."""
        iv = sorted((a, b) for _, a, b in self.kernels + self.copies)
        gaps, end = [], self.t0_ns
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1_ns > end:
            gaps.append((end, self.t1_ns))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for g0, g1 in gaps:
            cover: dict = defaultdict(int)
            for label, s0, s1, *_ in spans:
                o = min(s1, g1) - max(s0, g0)
                if o > 0:
                    cover[label] += o
            top = sorted(cover, key=lambda k: -cover[k])
            label = "|".join(k for k in top if 2 * cover[k] >= g1 - g0) \
                or (top[0] if top else "host")
            out.append([label, (g1 - g0) / 1e9])
        return out
