"""Beam powers (``io/sink.py::PBeamOutput``): one sender per dual-pol
beam, ``ntime_sum`` spectra averaged; judged by the largest error of a
window's powers over its largest reference power."""

from __future__ import annotations

import numpy as np

from ..reference import decode
from . import LoopbackSend, gain_commands

ATTR = "pbeam_outputs"
METHOD = "send_powers"
SEQ_ARG = 1
NUMBERS = {"power_err": max}


def commands(cfg, conf, traffic, seed, commanded) -> list:
    return gain_commands(cfg, traffic, seed, commanded)


def build(cfg, conf):
    from caltech_bifrost_dsp_tpu_torch.io import sink as psink

    sends = {b: LoopbackSend() for b in range(cfg.nbeam // 2)}
    return psink.PBeamOutput(cfg, senders=sends), list(sends.values())


def decode_packet(pkt: bytes):
    h, data = decode.pbeam(pkt)
    return h["seq"], (h, data)


def judge(w: int, records: list, ref):
    p = ref.p
    acc_len, ntime_sum, nchan = p["acc_len"], p["ntime_sum"], p["nchan"]
    nbeam2, nblk = p["nbeam"] // 2, acc_len // ntime_sum
    want = ref.power(w)
    got = np.full_like(want, np.nan)
    good = bad = 0
    for h, data in records:
        b, off = h["beam"] - 1, h["seq"] - w * acc_len
        blk = off // ntime_sum
        if not (0 <= b < nbeam2 and 0 <= blk < nblk
                and off % ntime_sum == 0 and h["navg"] == ntime_sum
                and h["nchan"] == nchan
                and h["chan0"] == p["pipeline_id"] * nchan
                and h["nbeam"] == 1 and np.isnan(got[b, blk]).all()):
            bad += 1
            continue
        got[b, blk] = data[:, 0, :]
        good += 1
    bad += max(0, nbeam2 * nblk - good)
    if ref.control:
        got = ref.power(w, control=True)
    got = np.where(np.isnan(got), want, got)   # counted in packets_bad
    err = float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                             or 1.0)
    return good, bad, {"power_err": err}
