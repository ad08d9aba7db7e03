"""The full-correlation output's packets: a decoder of the LWA-SV "COR"
(Mark 5C) packet and the float64 reference of one slow period's
visibility matrix, as the packets carry it.

The packet, as the upstream writes it (caltech-bifrost-dsp
``docs/source/outputs.rst``; bifrost's ``cor_<nchan>`` packet writer,
``corr_output_full_block.py:497-548,655-664``), one dual-pol baseline
each, big-endian throughout:

- a 32-byte header: u32 sync word ``0xDEC0DE5C``; u8 packet id (2, COR)
  and u24 frame number ``(nchan_sum << 16) | (nsubband << 8) | subband``
  (1-indexed); u32 seconds count (sync time plus the first spectrum over
  the spectra rate, in whole seconds); u16 frequency count (the first
  channel); u16 gain (0); u64 time tag and u32 navg (the first spectrum
  and the integration, in ADC samples); u16 stand i, u16 stand j
  (1-indexed, i <= j, stand j conjugated);
- int32 ``[nchan, npol of i, npol of j, (re, im)]``.

A slow dump sends one packet for each stand pair i <= j.  The reference
of the period that starts at fast window ``w`` is ``sum_v count_v V(v)``
over the gulps of its ``acc_len_slow / acc_len`` windows, ``V`` of
:func:`.xengine.correlate` on :class:`.check.Inputs` (``V[c, a, b] =
sum_t x_a conj(x_b)``), in channel blocks on the reference's device.
Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch

from . import xengine as xr

HEADER = np.dtype([("sync", ">u4"), ("id_frame", ">u4"), ("secs", ">u4"),
                   ("freq", ">u2"), ("gain", ">u2"), ("time_tag", ">u8"),
                   ("navg", ">u4"), ("stand_i", ">u2"), ("stand_j", ">u2")])
SYNC = 0xDEC0DE5C
COR_ID = 2
#: ADC samples a spectrum: the F-engine's 4096-channel real transform
#: (``fs_hz / chan_bw_hz`` of every configuration here)
SAMPLES_PER_SPECTRUM = 2 * 4096
#: channels per block of the reference
CHAN_BLOCK = 16


def decode(pkt: bytes) -> tuple[dict, np.ndarray]:
    """-> (header fields, data int32 [nchan, 2, 2, (re, im)])."""
    if len(pkt) < HEADER.itemsize or (len(pkt) - HEADER.itemsize) % 32:
        raise ValueError("COR packet of the wrong length")
    f = np.frombuffer(pkt, HEADER, 1)[0]
    if int(f["sync"]) != SYNC:
        raise ValueError(f"bad COR sync word {int(f['sync']):#x}")
    if int(f["id_frame"]) >> 24 != COR_ID:
        raise ValueError("not a COR packet")
    h = {k: int(f[k]) for k in HEADER.names if k not in ("sync",
                                                          "id_frame")}
    h["frame"] = int(f["id_frame"]) & 0xFFFFFF
    data = np.frombuffer(pkt, ">i4", offset=HEADER.itemsize)
    return h, data.reshape(-1, 2, 2, 2)


def expected_header(p: dict, w: int, sync_time: int = 0) -> dict:
    """The header fields every packet of the slow dump whose period starts
    at fast window ``w`` carries (all but the stands)."""
    sps = round(p["fs_hz"] / p["chan_bw_hz"])
    first = w * p["acc_len"]
    return {"frame": ((1 << 16) | (p["npipeline"] << 8)
                      | (p["pipeline_id"] % p["npipeline"] + 1)),
            "secs": int(sync_time + first * sps / p["fs_hz"]),
            "freq": p["pipeline_id"] * p["nchan"], "gain": 0,
            "time_tag": first * sps, "navg": p["acc_len_slow"] * sps}


def pair_rows(nstand: int) -> np.ndarray:
    """[nstand, nstand] row of stand pair (i, j), i <= j, in a dump's
    packet order (i major); -1 below the diagonal."""
    row = np.full((nstand, nstand), -1, np.int64)
    i, j = np.triu_indices(nstand)
    row[i, j] = np.arange(len(i))
    return row


def period_counts(ref, w: int) -> dict:
    """{variant: gulps} of the slow period starting at fast window ``w``
    (``ref``: :class:`.check.Reference`)."""
    p = ref.p
    counts: dict = {}
    for ww in range(w, w + p["acc_len_slow"] // p["acc_len"]):
        for v in ref.variants(ww):
            counts[v] = counts.get(v, 0) + 1
    return counts


def period_block(ref, counts: dict, c0: int, c1: int,
                 dtype=torch.float64) -> tuple:
    """The period's matrix (real, imag) [c1 - c0, ninput, ninput] of
    channels c0..c1, each variant's correlation cast to ``dtype`` and
    summed in it."""
    acc = None
    for v, k in counts.items():
        vr, vi = (k * x for x in xr.correlate(*ref.inputs.samples(v, c0,
                                                                  c1)))
        vr, vi = vr.to(dtype), vi.to(dtype)
        if acc is None:
            acc = [vr, vi]
        else:
            acc[0] += vr
            acc[1] += vi
    return tuple(acc)


def _pairs(plane: torch.Tensor, si, sj, nstand: int, npol: int):
    """[c, (i, p0), (j, p1)] -> [pair, c, p0, p1] float64 of stand pairs
    (si, sj)."""
    c = plane.shape[0]
    return plane.reshape(c, nstand, npol, nstand, npol)[:, si, :, sj, :].to(
        torch.float64)


def mismatch(ref, w: int, got: np.ndarray, seen: np.ndarray) -> int:
    """int32 values (both parts) of the packets of the period starting at
    ``w`` that differ from the reference: ``got`` [npair, nchan, 2, 2,
    (re, im)] in packet order, ``seen`` [npair] the rows that arrived."""
    p = ref.p
    nstand, npol, nchan = p["nstand"], p["npol"], p["nchan"]
    rows = np.flatnonzero(seen)
    if not len(rows):
        return 0
    i, j = np.triu_indices(nstand)
    si = torch.from_numpy(i[rows]).to(ref.device)
    sj = torch.from_numpy(j[rows]).to(ref.device)
    counts = period_counts(ref, w)
    bad = 0
    for c0 in range(0, nchan, CHAN_BLOCK):
        c1 = min(nchan, c0 + CHAN_BLOCK)
        have = torch.from_numpy(np.ascontiguousarray(
            got[rows, c0:c1])).to(ref.device).to(torch.float64)
        for part, plane in enumerate(period_block(ref, counts, c0, c1)):
            want = _pairs(plane, si, sj, nstand, npol)
            bad += int((have[..., part] != want).sum())
    return bad


def control_mismatch(ref, w: int, dtype) -> int:
    """The comparison's control: the ``cor_mismatch`` a dump of the period
    starting at ``w`` would read, had it carried the period summed in
    ``dtype`` (torch.float32, torch.float16) instead of the exact values:
    the values of every packet where the two differ."""
    p = ref.p
    nstand, npol, nchan = p["nstand"], p["npol"], p["nchan"]
    si, sj = (torch.from_numpy(x).to(ref.device)
              for x in np.triu_indices(nstand))
    counts = period_counts(ref, w)
    bad = 0
    for c0 in range(0, nchan, CHAN_BLOCK):
        c1 = min(nchan, c0 + CHAN_BLOCK)
        for exact, low in zip(period_block(ref, counts, c0, c1),
                              period_block(ref, counts, c0, c1, dtype)):
            bad += int((_pairs(exact, si, sj, nstand, npol)
                        != _pairs(low, si, sj, nstand, npol)).sum())
    return bad
