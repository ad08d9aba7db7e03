"""On-card golden-parity gate of the PyTorch + CUDA port: the counterpart of
``caltech_bifrost_dsp_tpu/scripts/tpu_parity.py``.

Runs the port's production program, the one the pipeline CLI runs by
default and ``scripts/bench_step.py`` measures (``models/xengine.py::
xengine_step`` with ``config.TPU_ENGINES`` on the chan-major ``cti``
staging, 768 lanes at 704 inputs), on the card over the golden windows
(``verification/golden.py``, seed 0xdeadbeef) at the reference's
production geometry, 7200 spectra x 352 stands x 2 pol in windows of 2400,
at both shipped channel counts (192 and 184), and requires EXACT integer
equality on

  * every element of every fast dump (3 per geometry),
  * the slow accumulator after the last window (the sum of all three),
  * every element of every subselection output (4704 baselines, 4-channel
    sums), and
  * the VLBI voltages of beams 0 and 1 (exact: with integer gains every
    bf16 product and float32 partial sum is an integer below 2^24),

plus the beam powers within rtol 1e-4, atol 1e-4 x max of a float64 host
reference (the power stage rounds |v|^2 in float32).

The truth is the host's, never the port's: exact float32 GEMMs for the
visibilities (:func:`..verification.golden.host_corr_int32`; every partial
sum is an integer below 2^24), anchored on the first window to
:func:`..verification.golden.reference_correlation` (complex128) on two
channels, and float64 for the beams.  A convention shared by a kernel and
its plain version therefore cannot pass.

The FX leg (:func:`run_fx`, skip with ``--no-fx``) holds the direct
channelizer (``ops/pfb_fused.py::pfb_quantize_packed``, 192 channels x 704
inputs x 600 spectra, 4 taps) to a float64 host PFB: int8 ADC bytes equal
to the same values fed as float32; ``fast=False`` and ``fast=True`` bytes
>= 99.9% and >= 99.5% identical, off by <= 1 code elsewhere; and the
``fast=False`` bytes under the port's own byte gate
(``ops/pfb.py::packed_mismatches``, the rule ``assert_packed_close``
raises on: a nibble may differ by one code only within 1e-3 of a rounding
threshold).

Writes a JSON artifact (default ``GPUPARITY_torch.json``; a file in the
temporary directory for ``--tiny`` runs) with each window's verdicts, the
card's name and power limit, the commit (``CBD_COMMIT`` names it in a copy
without ``.git``), the engines and the seconds of each section.  Exit 0
only when every section passes, 1 when one fails, 2 when the card asked for
is missing or the full gate is asked of the CPU.  Nothing is caught: a
kernel that fails to build or launch fails the run.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.gpu_parity   # the card
    cbd-torch-parity --tiny --device cpu     # logic self-test on the CPU
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import LWA352_TPU, TPU_ENGINES
from ..models.xengine import dense_vis, init_state, xengine_step
from ..ops import corr_subsel as cs
from ..ops import pfb
from ..ops.beamform import BeamGains
from ..ops.kernels import _build
from ..ops.pfb_fused import pfb_quantize_packed
from ..utils.codec import pack_np, unpack_np
from ..utils.roofline import card_fields, current_commit
from ..verification import golden
from ..verification.golden import host_beams, host_power

DEFAULT_OUT = "GPUPARITY_torch.json"
#: the staged input axis is padded to a multiple of this (704 -> 768), as
#: the JAX gate pads it to its Pallas correlator's block
LANE_BLOCK = 256
#: pad-lane byte of the staging, -8-8j (see :func:`run_geometry`)
PAD_BYTE = 0x88
#: the per-window keys that must be exact
EXACT_KEYS = ("fast_re", "fast_im", "subsel_re", "subsel_im", "vlbi")


def host_subsel(vr, vi, pairs, nchan_sum: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Exact subselection from the host dense matrix: gather [c, i0, i1],
    then sum channel groups (int64 on the host; the sums fit int32)."""
    nchan = vr.shape[0]
    i0, i1 = pairs[:, 0], pairs[:, 1]
    sr = vr[:, i0, i1].astype(np.int64)
    si = vi[:, i0, i1].astype(np.int64)
    sr = sr.reshape(nchan // nchan_sum, nchan_sum, -1).sum(1)
    si = si.reshape(nchan // nchan_sum, nchan_sum, -1).sum(1)
    return sr.astype(np.int32), si.astype(np.int32)


def _eq(a, b) -> dict:
    """``{"exact": bool}``, with the count of differing elements and the
    largest difference where they differ."""
    a = np.asarray(a)
    b = np.asarray(b)
    exact = bool(np.array_equal(a, b))
    out = {"exact": exact}
    if not exact:
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        out["mismatches"] = int((d > 0).sum())
        out["max_abs_diff"] = int(d.max())
    return out


def _anchor(block: np.ndarray, hvr: np.ndarray, hvi: np.ndarray) -> dict:
    """The host GEMM truth against the complex128 golden correlation on
    the first two channels."""
    ncheck = min(2, block.shape[1])
    ni = hvr.shape[1]
    gold = golden.reference_correlation(block[:, :ncheck])
    gold = gold.transpose(0, 1, 3, 2, 4).reshape(ncheck, ni, ni)
    return {"nchan": ncheck,
            "re": _eq(hvr[:ncheck], gold.real.astype(np.int64)),
            "im": _eq(hvi[:ncheck], gold.imag.astype(np.int64))}


def run_geometry(nchan: int, ntime: int, nstand: int, art: dict,
                 device: str = "cuda", tiny: bool = False) -> bool:
    """Run the production step over ``ntime // acc_len`` golden windows at
    ``nchan`` channels on ``device``; record each window's verdicts in
    ``art["geometries"]["<nchan>c"]`` and return whether all passed."""
    t_start = time.perf_counter()
    if tiny:
        cfg = LWA352_TPU.replace(nstand=nstand, nchan=nchan, ntime_gulp=48,
                                 acc_len=96, acc_len_slow=96 * 3, nbeam=4,
                                 ntime_sum=12, nchan_sum=4)
    else:
        cfg = LWA352_TPU.replace(nchan=nchan, nstand=nstand)
    acc = cfg.acc_len
    if ntime % acc:
        raise ValueError(f"ntime {ntime} is not a multiple of acc_len {acc}")
    ni = cfg.ninput
    lanes = -(-ni // LANE_BLOCK) * LANE_BLOCK

    # integer gains: exact in bf16, so the beamformer's products and float32
    # partial sums are exact and the VLBI voltages must be bit-equal
    grng = np.random.RandomState(0xBF)
    gr = grng.randint(-8, 9, [cfg.nchan, cfg.nbeam, ni]).astype(np.float32)
    gi = grng.randint(-8, 9, [cfg.nchan, cfg.nbeam, ni]).astype(np.float32)
    gains = BeamGains(torch.from_numpy(gr).to(device),
                      torch.from_numpy(gi).to(device))
    pairs_np = cs.baselines_to_inputs(
        cs.production_baselines(cfg.nvis_out, cfg.nstand, cfg.npol),
        cfg.npol).astype(np.int32)
    pairs = torch.from_numpy(pairs_np).to(device)
    state = init_state(cfg, device)
    # Pad lanes hold 0x88 = -8-8j, not the JAX gate's zeros: a kernel that
    # read a pad lane would change the products, where zeros hide the read.
    staged = torch.full((nchan, acc, lanes), PAD_BYTE, dtype=torch.uint8,
                        device=device)

    geom = {"nchan": nchan, "ntime": ntime, "nstand": nstand,
            "acc_len": acc, "windows": []}
    art["geometries"]["%dc" % nchan] = geom
    ok = True
    host_s = 0.0
    slow_re = slow_im = None
    blocks = golden.generate_input_blocks(ntime, nchan, cfg.nstand,
                                          cfg.npol, acc)
    for w, block in enumerate(blocks):
        staged[:, :, :ni] = torch.from_numpy(
            block.reshape(acc, nchan, ni)).to(device).permute(1, 0, 2)
        state, outs = xengine_step(state, staged, gains, pairs, True, True,
                                   w == 0, cfg, layout="cti")
        dre, dim = (p.cpu().numpy() for p in dense_vis(state.vis_fast, cfg))
        got_ss = outs.subsel.real.cpu().numpy(), outs.subsel.imag.cpu().numpy()
        vlbi = outs.vlbi.cpu().numpy()                 # [t, c, 2, 2]
        power = outs.bf_power.cpu().numpy().astype(np.float64)

        th = time.perf_counter()
        hvr, hvi = golden.host_corr_int32(block)
        if w == 0:
            geom["anchor"] = _anchor(block, hvr, hvi)
            anchor_ok = (geom["anchor"]["re"]["exact"]
                         and geom["anchor"]["im"]["exact"])
            ok = ok and anchor_ok
        if slow_re is None:
            slow_re, slow_im = hvr.copy(), hvi.copy()
        else:
            slow_re += hvr
            slow_im += hvi
        ssr, ssi = host_subsel(hvr, hvi, pairs_np, cfg.nchan_sum)
        br, bi = host_beams(block, gr, gi)
        hv = np.stack([br[:, :2], bi[:, :2]], axis=-1)  # [c, 2, t, 2]
        hv = hv.transpose(2, 0, 1, 3).astype(np.float32)
        hp = host_power(br, bi, cfg.ntime_sum)
        host_s += time.perf_counter() - th

        win = {"window": w, "fast_re": _eq(dre, hvr), "fast_im": _eq(dim, hvi),
               "subsel_re": _eq(got_ss[0], ssr),
               "subsel_im": _eq(got_ss[1], ssi),
               "vlbi": {"exact": bool(np.array_equal(vlbi, hv))}}
        atol = 1e-4 * float(np.abs(hp).max())
        win["power"] = {
            "allclose_rtol1e-4": bool(np.allclose(power, hp, rtol=1e-4,
                                                  atol=atol)),
            "max_rel_err": float(np.max(np.abs(power - hp)
                                        / (np.abs(hp) + atol)))}
        geom["windows"].append(win)
        exact_ok = all(win[k]["exact"] for k in EXACT_KEYS)
        ok = ok and exact_ok and win["power"]["allclose_rtol1e-4"]
        print(f"[{nchan}c] window {w}: "
              + ("EXACT" if exact_ok else f"MISMATCH {win}")
              + f" (power rel err {win['power']['max_rel_err']:.2e})",
              flush=True)
        del dre, dim, hvr, hvi, br, bi

    sre, sim = (p.cpu().numpy() for p in dense_vis(state.vis_slow, cfg))
    geom["slow_re"] = _eq(sre, slow_re)
    geom["slow_im"] = _eq(sim, slow_im)
    slow_ok = geom["slow_re"]["exact"] and geom["slow_im"]["exact"]
    ok = ok and slow_ok
    geom["host_seconds"] = round(host_s, 3)
    geom["seconds"] = round(time.perf_counter() - t_start, 3)
    geom["pass"] = ok
    print(f"[{nchan}c] slow accumulator: "
          + ("EXACT" if slow_ok else "MISMATCH")
          + f"; host truth vs golden.reference_correlation on "
          f"{geom['anchor']['nchan']} channels: "
          + ("EXACT" if anchor_ok else "MISMATCH")
          + f" — geometry {'PASS' if ok else 'FAIL'} ({geom['seconds']} s, "
          f"host truth {geom['host_seconds']} s)", flush=True)
    return ok


def _nibble_cmp(a: np.ndarray, b: np.ndarray) -> tuple[float, int]:
    """(share of identical bytes, largest code difference of a nibble)."""
    ar, ai = unpack_np(a)
    br, bi = unpack_np(b)
    same = float(np.mean(a == b))
    return same, int(max(np.abs(ar - br).max(), np.abs(ai - bi).max()))


def run_fx(art: dict, device: str = "cuda", tiny: bool = False,
           nspec: int = 600, nchan: int = 192, ninput: int = 704,
           ntap: int = 4) -> bool:
    """The channelizer against a float64 host PFB on ``device``; records
    ``art["fx"]`` and returns whether it passed."""
    t0 = time.perf_counter()
    if tiny:
        nspec, nchan, ninput = 48, 32, 16
    L = 2 * nchan
    rng = np.random.RandomState(0xF0)
    t = np.arange((nspec + ntap - 1) * L)
    scene = (10.0 * rng.standard_normal([t.size, ninput])
             + 60.0 * np.cos(2 * np.pi * (min(100, nchan - 2) / L)
                             * t[:, None])).astype(np.float32)
    adc_i8 = np.clip(np.rint(scene), -127, 127).astype(np.int8)
    adc_f32 = adc_i8.astype(np.float32)
    w = pfb.pfb_window(nchan, ntap)

    th = time.perf_counter()
    ref = pfb.pfb_reference_np(adc_f32.astype(np.float64),
                               np.asarray(w, np.float64), nchan, ntap)
    ref = np.moveaxis(ref, 2, 0)            # [ninput, nspec, nchan]
    scale = float(7.0 / np.abs(ref).max())
    pre = ref.astype(np.complex128) * scale
    ref_pk = pack_np(*(np.clip(np.round(p), -8, 7) for p in (pre.real,
                                                              pre.imag)))
    host_s = time.perf_counter() - th

    def card(x, fast):
        return pfb_quantize_packed(torch.from_numpy(x).to(device), w, nchan,
                                   ntap, scale, fast=fast).cpu().numpy()

    rec = {"nspec": nspec, "nchan": nchan, "ninput": ninput,
           "chunks": None,
           "chunks_reason": "the JAX kernel's pipeline_chunks is a Mosaic "
                            "schedule; the CUDA kernel has no such option"}
    hi_i8 = card(adc_i8, fast=False)
    hi_f32 = card(adc_f32, fast=False)
    rec["int8_eq_f32"] = bool(np.array_equal(hi_i8, hi_f32))
    same_hi, lsb_hi = _nibble_cmp(hi_i8, ref_pk)
    rec["high_vs_host"] = {"frac_identical": round(same_hi, 6),
                           "max_lsb_diff": lsb_hi}
    tolerated, bad = pfb.packed_mismatches(
        torch.from_numpy(hi_i8), torch.from_numpy(ref_pk),
        torch.from_numpy(pre.real), torch.from_numpy(pre.imag))
    rec["byte_gate"] = {"tolerated": tolerated, "bad": bad}
    bf = card(adc_i8, fast=True)
    same_bf, lsb_bf = _nibble_cmp(bf, ref_pk)
    rec["bf16_vs_host"] = {"frac_identical": round(same_bf, 6),
                           "max_lsb_diff": lsb_bf}
    ok = (rec["int8_eq_f32"] and bad == 0
          and same_hi >= 0.999 and lsb_hi <= 1
          and same_bf >= 0.995 and lsb_bf <= 1)
    rec["host_seconds"] = round(host_s, 3)
    rec["seconds"] = round(time.perf_counter() - t0, 3)
    rec["pass"] = ok
    art["fx"] = rec
    print(f"[fx] int8==f32: {rec['int8_eq_f32']}  high vs host: "
          f"{same_hi:.4%}/<= {lsb_hi} LSB, byte gate {bad} bad "
          f"({tolerated} at a threshold)  bf16 vs host: {same_bf:.4%}/<= "
          f"{lsb_bf} LSB — {'PASS' if ok else 'FAIL'} ({rec['seconds']} s)",
          flush=True)
    return ok


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="on-card golden-parity gate at production geometry")
    p.add_argument("--out", default=None,
                   help=f"artifact path (default {DEFAULT_OUT}; a file in "
                        "the temporary directory for --tiny, so a "
                        "self-test cannot overwrite the card's record)")
    p.add_argument("--nchan", type=int, nargs="+", default=[192, 184],
                   help="channel geometries (the reference ships 192c and "
                        "184c vectors)")
    p.add_argument("--ntime", type=int, default=7200,
                   help="samples (the shipped vectors hold 7200)")
    p.add_argument("--nstand", type=int, default=352)
    p.add_argument("--no-fx", action="store_true",
                   help="skip the FX channelizer leg")
    p.add_argument("--only-fx", action="store_true",
                   help="run only the FX channelizer leg")
    p.add_argument("--tiny", action="store_true",
                   help="small self-test configuration")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the kernels; cpu (with --tiny only) "
                        "their plain versions")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available (use "
              "--tiny --device cpu for the logic self-test)", file=sys.stderr)
        return 2
    if args.device == "cpu" and not args.tiny:
        print("error: the gate must run on the card: on the CPU every "
              "wrapper takes its plain version and the run proves nothing "
              "about the kernels. Use --tiny for a logic self-test.",
              file=sys.stderr)
        return 2
    if args.out is None:
        args.out = (os.path.join(tempfile.gettempdir(),
                                 "gpuparity_selftest.json")
                    if args.tiny else DEFAULT_OUT)

    cuda = args.device == "cuda"
    card = card_fields() if cuda else {"device": None, "power_limit": None}
    art = {"backend": args.device,
           "device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "card": card["device"], "power_limit": card["power_limit"],
           "commit": current_commit(),
           "engines": dict(TPU_ENGINES), "layout": "cti",
           "seed": "0xdeadbeef (reference make_golden_inputs.py:20)",
           "geometries": {}}
    # partial runs (--only-fx / --no-fx) merge into an existing artifact
    # so the file always carries every section's latest result
    if os.path.exists(args.out) and (args.only_fx or args.no_fx):
        try:
            with open(args.out) as fh:
                prev = json.load(fh)
        except (OSError, ValueError):
            prev = {}
        if prev.get("backend") == art["backend"]:
            art["geometries"] = prev.get("geometries", {})
            if "fx" in prev:
                art["fx"] = prev["fx"]
    if cuda:
        t0 = time.perf_counter()
        _build.library()
        art["build_seconds"] = round(time.perf_counter() - t0, 3)
    ok = True
    if not args.only_fx:
        for nchan in args.nchan:
            ok = run_geometry(nchan, args.ntime, args.nstand, art,
                              args.device, args.tiny) and ok
    if not args.no_fx:
        ok = run_fx(art, args.device, args.tiny) and ok
    sections = list(art["geometries"].values())
    if "fx" in art:
        sections.append(art["fx"])
    # the verdict ANDs in sections merged from earlier partial runs; the
    # exit code agrees with it, not only with the legs run now
    art["pass"] = ok and all(s.get("pass", False) for s in sections)
    art["time_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    with open(args.out, "w") as fh:
        json.dump(art, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(("PASS" if art["pass"] else "FAIL") + f" -> {args.out}", flush=True)
    return 0 if art["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
