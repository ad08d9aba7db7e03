"""VLBI voltages (``io/sink.py::IBeamOutput``): one packet a spectrum
for the two VLBI beams, under the sink's 0.6 Gb/s cap (the harness
refuses a program whose cap is not the configuration's); judged by the
largest error of a window's voltages over its largest reference
voltage."""

from __future__ import annotations

import numpy as np

from ..reference import decode
from . import LoopbackSend, gain_commands

ATTR = "ibeam_outputs"
METHOD = "send_voltages"
SEQ_ARG = 1
NUMBERS = {"vlbi_err": max}


def commands(cfg, conf, traffic, seed, commanded) -> list:
    return gain_commands(cfg, traffic, seed, commanded)


def build(cfg, conf):
    from caltech_bifrost_dsp_tpu_torch.io import sink as psink

    cap = conf["sinks"]["ibeam"]["max_bps"]
    if psink.IBeamOutput.MAX_BPS != cap:
        raise RuntimeError(f"IBEAM cap {psink.IBeamOutput.MAX_BPS} is not "
                           f"the configuration's {cap}")
    send = LoopbackSend()
    return psink.IBeamOutput(cfg, send=send), [send]


def decode_packet(pkt: bytes):
    h, data = decode.ibeam(pkt)
    return h["seq"], (h, data)


def judge(w: int, records: list, ref):
    p = ref.p
    acc_len, nchan = p["acc_len"], p["nchan"]
    want = ref.vlbi(w)
    got = np.full_like(want, np.nan)
    good = bad = 0
    for h, data in records:
        t = h["seq"] - w * acc_len
        if not (0 <= t < acc_len and h["nchan"] == nchan
                and h["chan0"] == p["pipeline_id"] * nchan
                and h["nbeam"] == 2 and np.isnan(got[t]).all()):
            bad += 1
            continue
        got[t] = data
        good += 1
    bad += max(0, acc_len - good)
    if ref.control:
        got = ref.vlbi(w, control=True)
    got = np.where(np.isnan(got), want, got)   # counted in packets_bad
    err = float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                             or 1.0)
    return good, bad, {"vlbi_err": err}
