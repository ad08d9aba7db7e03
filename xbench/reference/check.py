"""The comparison that decides ``correct``.

It judges what the timed path produced, at the timed sizes: the int32
fast and slow accumulators the driver's state holds once the window has
closed, and, where the traffic has sinks, every packet of a seeded
sample of fast windows as it left the sinks.  The reference works
everything out again in float64 from the pool gulps the harness made and
what it commanded (:mod:`.xengine`); it takes nothing the program
derived.

The accumulators are compared by the configuration's input kind
(:data:`ACCUMULATOR`); the packets by the sinks the traffic lists, each
sink's module (``xbench/sinks/<name>.py``) judging its own packets
against :class:`Reference`, whatever the input kind.  Numbers compared,
each with its limit from the cell's file:

- ``vis_mismatch`` (packed input): upper-triangle entries (j >= i, both
  planes) of the fast and slow accumulators that differ from the
  reference (exact: 0);
- ``vis_rel_err`` (ADC input): ||got - ref|| / ||ref|| of each
  accumulator over its upper triangle, the larger of the two; the 4-bit
  codes of a float32 channelizer may round the other way where a value
  lies at a threshold, so these accumulators are not exact;
- ``packets_bad``: packets that do not decode, carry a wrong header, or
  are missing in the sampled windows (exact: 0);
- each sink's numbers (``subsel_mismatch``, ``power_err``,
  ``vlbi_err``);
- ``windows_unchecked``: fewer than two sampled windows (0).

The control (``control=True``) is the configuration's ``control``: with
``{"reference": "tf32_gains"}`` the reference itself, with the
beamformer's gains rounded to TF32 and float32 sums, takes the place of
the program's beams; with ``{"program": {...}}`` the program runs with
those settings (its own lower-precision path, set by the harness).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import xengine as xr

#: the accumulator number of each input kind
ACCUMULATOR = {"packed": "vis_mismatch", "adc_int8": "vis_rel_err"}

#: channels per block of the accumulator comparison
CHAN_BLOCK = 16


def window_gulps(w: int, gpw: int) -> list[int]:
    """Stream gulp indices of fast window ``w``."""
    return [w * gpw + j for j in range(gpw)]


def coefficients(nwin: int, gpw: int, slow_nwin: int, variant) -> tuple:
    """{variant: count} of the last window's gulps (fast accumulator) and
    of the gulps since the last slow boundary (slow accumulator), for
    ``nwin`` windows stepped; ``variant(n)`` names gulp n's input."""
    fast: dict = {}
    slow: dict = {}
    last = nwin - 1
    s0 = (last // slow_nwin) * slow_nwin
    for w in range(s0, nwin):
        for n in window_gulps(w, gpw):
            v = variant(n)
            slow[v] = slow.get(v, 0) + 1
            if w == last:
                fast[v] = fast.get(v, 0) + 1
    return fast, slow


def _upper(n: int, device) -> torch.Tensor:
    i = torch.arange(n, device=device)
    return (i[None, :] >= i[:, None])[None]


def accumulator_blocks(xc_of, fast_c: dict, slow_c: dict, nchan: int,
                       fast_planes, slow_planes, device, exact: bool):
    """Compare the program's accumulators with sum_v count_v V(v), where
    ``xc_of(v, c0, c1)`` gives variant v's samples (re, im) float64
    [c, t, i] for channels c0..c1.  Returns ({"fast", "slow"}: entries
    that differ, {"fast", "slow"}: relative norm of the difference)."""
    bad = {"fast": 0, "slow": 0}
    num = {"fast": 0.0, "slow": 0.0}
    den = {"fast": 0.0, "slow": 0.0}
    need = sorted(set(fast_c) | set(slow_c), key=str)
    for c0 in range(0, nchan, CHAN_BLOCK):
        c1 = min(nchan, c0 + CHAN_BLOCK)
        acc = {"fast": None, "slow": None}
        for v in need:
            vr, vi = xr.correlate(*xc_of(v, c0, c1))
            for key, coef in (("fast", fast_c), ("slow", slow_c)):
                k = coef.get(v, 0)
                if not k:
                    continue
                if acc[key] is None:
                    acc[key] = [k * vr, k * vi]
                else:
                    acc[key][0] += k * vr
                    acc[key][1] += k * vi
            del vr, vi
        mask = _upper(acc["fast"][0].shape[1], device)
        for key, planes in (("fast", fast_planes), ("slow", slow_planes)):
            for ref, got_np in zip(acc[key], planes):
                got = torch.from_numpy(got_np[c0:c1]).to(device).to(
                    torch.float64)
                d = (got - ref) * mask
                if exact:
                    bad[key] += int((d != 0).sum())
                num[key] += float((d * d).sum())
                den[key] += float(((ref * mask) ** 2).sum())
    rel = {k: float(np.sqrt(num[k] / den[k])) if den[k] else 0.0
           for k in num}
    return bad, rel


class Check:
    """One compared number with its limit."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, value, limit

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


def _chan_major(gulp: np.ndarray, c0: int, c1: int, device):
    """Packed host gulp [t, c, i] -> (re, im) float64 [c, t, i]."""
    g = torch.from_numpy(np.ascontiguousarray(gulp[:, c0:c1])).to(device)
    return xr.unpack(g.permute(1, 0, 2))


class Inputs:
    """The reference's samples of every stream gulp.  Packed input: pool
    gulp ``n % npool`` unpacked.  ADC input: the 4-bit codes of the
    reference's own channelizer over pool gulp ``n % npool`` behind the
    last ntap-1 frames of gulp n-1 (zeros before gulp 0, the start of the
    sequence), worked out once per variant."""

    def __init__(self, kind: str, p: dict, pool: list, device):
        if kind not in ACCUMULATOR:
            raise ValueError(f"no comparison for input kind {kind!r}")
        self.kind, self.p, self.pool, self.device = kind, p, pool, device
        self.exact = kind == "packed"
        self._codes: dict = {}

    def variant(self, n: int):
        if self.kind == "adc_int8" and n == 0:
            return "first"
        return n % len(self.pool)

    def _adc_codes(self, v):
        if v not in self._codes:
            p, pool = self.p, self.pool
            nchan, ntap = p["nchan"], p["pfb_ntap"]
            hist = (ntap - 1) * 2 * nchan
            g = 0 if v == "first" else v
            prev = (np.zeros((hist, pool[0].shape[1]), pool[0].dtype)
                    if v == "first" else pool[(g - 1) % len(pool)][-hist:])
            adc = torch.from_numpy(np.concatenate([prev, pool[g]])).to(
                self.device)
            self._codes[v] = xr.channelize_codes(
                adc, xr.pfb_window(nchan, ntap), nchan, ntap,
                float(np.float32(p["quant_scale"])))
        return self._codes[v]

    def samples(self, v, c0: int, c1: int):
        """Variant ``v``'s samples (re, im) float64 [c, t, i], channels
        c0..c1."""
        if self.kind == "packed":
            return _chan_major(self.pool[v], c0, c1, self.device)
        re, im = self._adc_codes(v)
        return (re[:, c0:c1].permute(1, 0, 2).to(torch.float64),
                im[:, c0:c1].permute(1, 0, 2).to(torch.float64))


class Reference:
    """The fast sinks' products of each fast window, worked out from
    :class:`Inputs` and what the harness commanded (``gains``: delays_ns,
    amps [beam, input]; ``baselines``: [nvis, 2, (stand, pol)]), each
    gulp once.  ``control``: the beams also as the control computes them
    (TF32 gains, float32 sums)."""

    def __init__(self, p: dict, conf: dict, inputs: Inputs,
                 commanded: dict, device, control: bool):
        self.p, self.conf, self.inputs = p, conf, inputs
        self.commanded, self.device, self.control = commanded, device, control
        self.gpw = p["acc_len"] // p["ntime_gulp"]
        self._gulp: dict = {}
        self._gains = None
        self._sel = None

    def variants(self, w: int) -> list:
        return [self.inputs.variant(n) for n in window_gulps(w, self.gpw)]

    def selection_rows(self) -> dict:
        """{baseline as a flat tuple: row} of the commanded selection."""
        return self._selection()[2]

    def _selection(self):
        if self._sel is None:
            bl = self.commanded["baselines"]
            sel = bl[:, :, 0] * self.p["npol"] + bl[:, :, 1]
            used = np.unique(sel)
            self._sel = (used, np.searchsorted(used, sel),
                         {tuple(b.reshape(-1)): k
                          for k, b in enumerate(bl)})
        return self._sel

    def _gain_planes(self):
        if self._gains is None:
            p = self.p
            d, a = self.commanded["gains"]
            self._gains = xr.beam_gains(d, a, p["nchan"],
                                        p["pipeline_id"] * p["nchan"],
                                        p["chan_bw_hz"], self.device)
        return self._gains

    def _products(self, v, what: str):
        key = (v, what)
        if key not in self._gulp:
            p = self.p
            re, im = self.inputs.samples(v, 0, p["nchan"])
            if what == "vis":
                used = torch.from_numpy(self._selection()[0]).to(
                    self.device)
                self._gulp[key] = xr.correlate(re[:, :, used],
                                               im[:, :, used])
            else:
                gr, gi = self._gain_planes()
                suffix = "_ctrl" if what.endswith("_ctrl") else ""
                if suffix:
                    gr, gi = (xr.round_tf32(x) for x in (gr, gi))
                    re, im = re.float(), im.float()
                br, bi = xr.beams(re, im, gr, gi)
                self._gulp[(v, "power" + suffix)] = xr.power(
                    br, bi, p["ntime_sum"]).double().cpu().numpy()
                self._gulp[(v, "vlbi" + suffix)] = xr.vlbi(
                    br, bi).double().cpu().numpy()
        return self._gulp[key]

    def power(self, w: int, control: bool = False) -> np.ndarray:
        """[beam pair, ntime / ntime_sum, chan, 4] of window ``w``."""
        what = "power_ctrl" if control else "power"
        return np.concatenate([self._products(v, what)
                               for v in self.variants(w)], axis=1)

    def vlbi(self, w: int, control: bool = False) -> np.ndarray:
        """[ntime, chan, 2, (re, im)] of window ``w``."""
        what = "vlbi_ctrl" if control else "vlbi"
        return np.concatenate([self._products(v, what)
                               for v in self.variants(w)], axis=0)

    def subsel(self, w: int) -> tuple:
        """(real, imag) int [chan / nchan_sum, nvis] of window ``w``."""
        vs = [self._products(v, "vis") for v in self.variants(w)]
        vr = sum(x[0] for x in vs)
        vi = sum(x[1] for x in vs)
        return tuple(x.cpu().numpy() for x in xr.subsel(
            vr, vi, self._selection()[1], self.p["nchan_sum"]))


def numbers(conf: dict, traffic: dict, sink_kinds: dict) -> list:
    """The names of the numbers a cell compares, each needing a limit."""
    out = [ACCUMULATOR[conf["input"]["kind"]]]
    if sink_kinds:
        out.append("packets_bad")
    for name in traffic.get("sinks", ()):
        out += list(sink_kinds[name].NUMBERS)
    return out


def compare(p: dict, conf: dict, sink_kinds: dict, pool: list, nwin: int,
            fast_planes, slow_planes, packets: dict, windows: set,
            commanded: dict, limits: dict, device,
            control: bool = False) -> tuple[list, int, int]:
    """The cell's comparison.  ``p`` holds the configuration's sizes,
    ``sink_kinds`` the traffic's sink modules by name, ``packets`` the
    kept packets by sink, ``windows`` the sampled fast windows the output
    thread called the sinks for, ``commanded`` what the harness
    commanded.  Returns (checks, answers compared, answers wrong): the
    two accumulators and each sampled window."""
    nchan, acc_len = p["nchan"], p["acc_len"]
    gpw = acc_len // p["ntime_gulp"]
    inputs = Inputs(conf["input"]["kind"], p, pool, device)
    fast_c, slow_c = coefficients(nwin, gpw, p["acc_len_slow"] // acc_len,
                                  inputs.variant)
    bad, rel = accumulator_blocks(inputs.samples, fast_c, slow_c, nchan,
                                  fast_planes, slow_planes, device,
                                  inputs.exact)
    name = ACCUMULATOR[inputs.kind]
    per = bad if inputs.exact else rel
    checks = [Check(name, sum(per.values()) if inputs.exact
                    else max(per.values()), limits[name])]
    failed = sum(int(v > limits[name]) for v in per.values())
    attempted = 2
    if not sink_kinds:
        return checks, attempted, failed

    win: dict = {}
    bad_pkt = 0
    for kind, pkts in packets.items():
        for pkt in pkts:
            try:
                seq, rec = sink_kinds[kind].decode_packet(pkt)
            except (ValueError, struct.error):
                bad_pkt += 1
                continue
            win.setdefault(seq // acc_len, {}).setdefault(kind, []).append(
                rec)
    ref = Reference(p, conf, inputs, commanded, device,
                    control and conf["control"].get("reference")
                    == "tf32_gains")
    per_sink: dict = {}
    judged = sorted(set(win) | set(windows))
    for w in judged:
        wrong = False
        for kind, mod in sink_kinds.items():
            _, nbad, nums = mod.judge(w, win.get(w, {}).get(kind, []), ref)
            bad_pkt += nbad
            wrong |= nbad > 0
            for k, v in nums.items():
                per_sink.setdefault(k, []).append(v)
                wrong |= v > limits[k]
        failed += int(wrong)
    checks.append(Check("packets_bad", bad_pkt, limits["packets_bad"]))
    for kind, mod in sink_kinds.items():
        for k, agg in mod.NUMBERS.items():
            checks.append(Check(k, agg(per_sink.get(k, [0])), limits[k]))
    checks.append(Check("windows_unchecked", max(0, 2 - len(judged)), 0))
    return checks, attempted + len(judged), failed
