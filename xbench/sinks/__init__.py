"""The product sinks, one module each, found by the name a traffic mix
lists under ``sinks`` (``xbench/sinks/<name>.py``).

Each sink's ``send`` is a :class:`LoopbackSend`, the real ``sendto`` to a
loopback port that the harness binds and never reads (the kernel drops
what overflows, as a network would), and :class:`SinkProxy` times each
call the output thread makes into a sink and marks the calls whose
packets the check keeps.

A sink module names

- ``ATTR``: the pipeline's list of such sinks (also its keyword);
- ``METHOD``, ``SEQ_ARG``: the call the output thread makes into the sink
  and the position of its first-spectrum argument;
- ``NUMBERS``: the numbers its comparison gives, each needing a limit in
  the cell's file;
- ``commands(cfg, conf, traffic, seed, commanded)``: the command-block
  messages the sink's products need, recording what they command in
  ``commanded`` (shared between sinks, so a command is sent once);
- ``build(cfg, conf)``: (the sink, its :class:`LoopbackSend` list);
- ``decode(pkt)``: (first spectrum, record) of one packet;
- ``expected(p)``: the packets of one fast window;
- ``judge(w, records, ref)``: (good packets, bad packets, {number:
  value}) of fast window ``w``, against :class:`xbench.reference.check.
  Reference` ``ref``.
"""

from __future__ import annotations

import importlib
import socket
import time

import numpy as np


class LoopbackSend:
    """A sink's send callable; keeps the packets sent while ``keep``."""

    def __init__(self):
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.bind(("127.0.0.1", 0))
        self.dest = self.rx.getsockname()
        self.tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.keep = False
        self.kept: list = []

    def __call__(self, pkt: bytes) -> None:
        self.tx.sendto(pkt, self.dest)
        if self.keep:
            self.kept.append(pkt)

    def close(self) -> None:
        self.tx.close()
        self.rx.close()


class SinkProxy:
    """Wraps a sink's bound method: records (label, start_ns, end_ns,
    window) in ``spans`` and sets ``keep`` on ``sends`` for the calls of
    windows ``keep_window(w)`` selects.  ``seq_arg`` is the position of
    the call's first-spectrum argument."""

    def __init__(self, label: str, fn, seq_arg: int, acc_len: int,
                 sends: list, keep_window, spans: list):
        self.label, self.fn, self.seq_arg = label, fn, seq_arg
        self.acc_len, self.sends = acc_len, sends
        self.keep_window, self.spans = keep_window, spans

    def __call__(self, *args, **kw):
        w = args[self.seq_arg] // self.acc_len
        keep = self.keep_window(w)
        for s in self.sends:
            s.keep = keep
        t0 = time.time_ns()
        try:
            return self.fn(*args, **kw)
        finally:
            self.spans.append((self.label, t0, time.time_ns(), w))
            for s in self.sends:
                s.keep = False


def spanned(label: str, fn, spans: list):
    """``fn`` recording (label, start_ns, end_ns, None) per call."""
    def call(*args, **kw):
        t0 = time.time_ns()
        try:
            return fn(*args, **kw)
        finally:
            spans.append((label, t0, time.time_ns(), None))
    return call


def kind(name: str):
    """The module of sink ``name`` (``xbench.sinks.<name>``)."""
    if not name.isidentifier():
        raise ValueError(f"bad sink name {name!r}")
    return importlib.import_module(f"xbench.sinks.{name}")


def seeded_gains(cfg, traffic: dict, seed: int) -> tuple:
    """Per-beam delays (ns) and amplitudes [beam, input] drawn from
    ``seed`` over the traffic's ``gains`` ranges."""
    rng = np.random.default_rng([seed, 2])
    g = traffic["gains"]
    return (rng.uniform(*g["delay_ns"], (cfg.nbeam, cfg.ninput)),
            rng.uniform(*g["amp"], (cfg.nbeam, cfg.ninput)))


def gain_commands(cfg, traffic: dict, seed: int, commanded: dict) -> list:
    """The Beamform command key's messages loading the seeded gains, once
    whichever beam sink asks first."""
    if "gains" in commanded:
        return []
    d, a = commanded["gains"] = seeded_gains(cfg, traffic, seed)
    return [("beam_cmd", {"coeffs": {
        "type": "beamcoeffs", "beam_id": b, "load_sample": -1,
        "data": {"delays": d[b].tolist(), "amps": a[b].tolist()}}})
        for b in range(cfg.nbeam)]
