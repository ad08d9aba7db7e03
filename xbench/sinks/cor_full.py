"""Full visibilities (``io/sink.py::CorrFullOutput``, ``use_cor_fmt``):
each slow dump as LWA-SV COR packets, one dual-pol baseline each, at the
configuration's ``max_mbps``, every value compared exactly.

The output thread calls the sink once a slow dump, with the period's
first spectrum: a call, and the packets it sends, are numbered by the
period's first fast window, and :func:`judge` checks the whole period
(:mod:`..reference.cor`)."""

from __future__ import annotations

import numpy as np

from ..reference import cor
from . import LoopbackSend

ATTR = "corr_outputs"
METHOD = "send_matrix_planes"
SEQ_ARG = 3
NUMBERS = {"cor_mismatch": sum}


def commands(cfg, conf, traffic, seed, commanded) -> list:
    return []


def build(cfg, conf):
    from caltech_bifrost_dsp_tpu_torch.io import sink as psink

    send = LoopbackSend()
    return psink.CorrFullOutput(
        cfg, send=send, max_mbps=conf["sinks"]["cor_full"]["max_mbps"],
        use_cor_fmt=True), [send]


def decode_packet(pkt: bytes):
    h, data = cor.decode(pkt)
    return h["time_tag"] // cor.SAMPLES_PER_SPECTRUM, (h, data)


def judge(w: int, records: list, ref):
    p = ref.p
    nstand, npol, nchan = p["nstand"], p["npol"], p["nchan"]
    if (w * p["acc_len"]) % p["acc_len_slow"]:
        # no slow period starts here: whatever arrived is misnumbered
        return 0, len(records), {"cor_mismatch": 0}
    want = cor.expected_header(p, w)
    row = cor.pair_rows(nstand)
    npair = nstand * (nstand + 1) // 2
    got = np.zeros((npair, nchan, npol, npol, 2), np.int32)
    seen = np.zeros(npair, bool)
    good = bad = 0
    for h, data in records:
        i, j = h["stand_i"] - 1, h["stand_j"] - 1
        k = row[i, j] if 0 <= i < nstand and 0 <= j < nstand else -1
        if (k < 0 or seen[k] or data.shape != got.shape[1:]
                or any(h[f] != v for f, v in want.items())):
            bad += 1
            continue
        seen[k] = True
        got[k] = data
        good += 1
    bad += npair - good
    return good, bad, {"cor_mismatch": cor.mismatch(ref, w, got, seen)}
