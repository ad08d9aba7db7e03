"""Partial visibilities (``io/sink.py::CorrPartOutput``): the commanded
baseline selection summed over ``nchan_sum`` channels, at the
configuration's ``max_mbps``, every value compared exactly."""

from __future__ import annotations

import numpy as np

from ..reference import decode
from ..reference import xengine as xr
from . import LoopbackSend

ATTR = "subsel_outputs"
METHOD = "send_subsel"
SEQ_ARG = 4
NUMBERS = {"subsel_mismatch": sum}


def commands(cfg, conf, traffic, seed, commanded) -> list:
    bl = commanded["baselines"] = xr.production_baselines(
        conf["sinks"]["subsel"]["nstand_selected"], cfg.npol)
    return [("subsel_cmd", {"baselines": bl.tolist()})]


def build(cfg, conf):
    from caltech_bifrost_dsp_tpu_torch.io import sink as psink

    s = conf["sinks"]["subsel"]
    send = LoopbackSend()
    return psink.CorrPartOutput(cfg, send=send, max_mbps=s["max_mbps"],
                                nvis_per_packet=s["nvis_per_packet"]), [send]


def decode_packet(pkt: bytes):
    h, bl, data = decode.part(pkt)
    return h["spectra_id"], (h, bl, data)


def judge(w: int, records: list, ref):
    p = ref.p
    nvis_pkt = ref.conf["sinks"]["subsel"]["nvis_per_packet"]
    row = ref.selection_rows()
    nvis = len(row)
    ref_r, ref_i = ref.subsel(w)
    seen = np.zeros(nvis, bool)
    good = bad = mismatch = 0
    for h, bl, data in records:
        idx = [row.get(tuple(b.reshape(-1).tolist()))
               for b in bl.astype(np.int64)]
        if (None in idx or h["acc_len"] != p["acc_len"]
                or h["spectra_id"] != w * p["acc_len"]
                or h["nchans"] != p["nchan"] // p["nchan_sum"]
                or h["chan0"] != p["pipeline_id"] * p["nchan"]
                // p["nchan_sum"]
                or seen[idx].any()):
            bad += 1
            continue
        seen[idx] = True
        good += 1
        mismatch += int((data[..., 0].T != ref_r[:, idx]).sum()
                        + (data[..., 1].T != ref_i[:, idx]).sum())
    bad += max(0, -(-nvis // nvis_pkt) - good)
    return good, bad, {"subsel_mismatch": mismatch}
