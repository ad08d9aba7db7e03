"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from ``caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc``,
holds each against its plain PyTorch version at the LWA-352 production
shapes (704 inputs, 192 channels, 2400-spectra window, 32 beams; the
channelizer also at the 4096-channel F-engine width; the correlators
also at a ragged shape), then drives five paths of the port, each with the
kernel launch counts set to 0 just before it and read just after:

- X/B: :class:`XEngineRunner` over the golden input stream (seed
  0xdeadbeef), three fast windows at 192 channels and one at 184;
- FX: :class:`XEngineRunner` in FX mode on int8 ADC, three windows and a
  slow dump at 192 channels, one at 184, one with float32 ADC (bytes equal
  to the int8 run's) and one tone window; per window the channelizer's
  bytes are gated against the float64 plain version, the X/B products are
  held exactly against the plain versions on those bytes, and the code
  histogram must not be degenerate;
- F-engine: ``channelize_pack_imajor`` at 4096 channels x 704 inputs x 240
  spectra (the factored DFT), gated the same way;
- driver: the operator entry point's :class:`XEnginePipeline` (ingest,
  compute and output threads) over three golden windows and one slow
  dump, twice: with the ``pallas_triu``/``pallas``/``pallas`` engines and
  with ``config.TPU_ENGINES``.  Integer gains arrive through the
  ``Beamform`` command key and the baseline selection through
  ``CorrSubsel``; the COR slow-dump packets, collected through ``send``,
  scatter back exactly to the plain slow dump, and the subselection, PBEAM
  and IBEAM packets, received on loopback UDP sockets by threads of this
  script, decode to the plain products (subselection and VLBI exact,
  power within rtol 1e-4);
- mesh: the sharded programs of ``parallel/mesh.py`` with the
  ``pallas_blk`` engines on 2x2 and 1x4 meshes whose four shards all lie
  on ``cuda:0``: the X/B configuration's three golden windows gulp by gulp
  and the slow dump through ``xengine_sharded_state_fn``, one int8 FX
  window with a carried ADC tail through ``fx_sharded_state_fn`` at 2x2,
  integers (and the packed bytes after the corner-turn) equal to the
  unsharded step's and beam products within rtol 1e-4; then
  ``XEnginePipeline(mesh=2x2)`` over the driver path's windows with every
  sink, its packets byte for byte those of the unsharded driver run.

A last run drives the two correlator schedules that no engine name
selects, ``corr_acc`` with the ``unpack_cache`` that is not the default and
``corr_rows``, over the golden stream through their wrappers and holds
their slow sums to the plain slow dump.

Beside the two tensor-core kernels it times a library contraction as a
yardstick, on earlier lines and labelled "contraction only":
``torch._int_mm`` on unpacked int8 planes beside the correlator, float32 and
float64 ``torch.matmul`` of the DFT's shape beside the direct channelizer.
They leave out the unpack, the FIR, the epilogue and the requantizer, so
``library_ms`` stays null; the port never calls them.

It times each kernel beside its plain version and its bound (the larger
of bytes moved over the memory rate and operations over the peak rate),
the X/B step (both correlator engines) and the FX step per window,
unsharded and sharded, and the driver's host time per window.  The last line is ``{"ok": true, "device": ...}``; any
failure raises and exits non-zero.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import math
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from caltech_bifrost_dsp_tpu_torch.config import LWA352, TPU_ENGINES
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch.io.source import (ADCSource,
                                                     SyntheticSource)
from caltech_bifrost_dsp_tpu_torch.models.xengine import (dense_vis, fx_step,
                                                          init_state,
                                                          xengine_step)
from caltech_bifrost_dsp_tpu_torch.ops import beamform as bf
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs
from caltech_bifrost_dsp_tpu_torch.ops import pfb, pfb_fused
from caltech_bifrost_dsp_tpu_torch.ops.corr_acc import (UNPACK_CACHE_DEFAULT,
                                                        corr_acc,
                                                        corr_acc_ref)
from caltech_bifrost_dsp_tpu_torch.ops import corr_blk as cblk
from caltech_bifrost_dsp_tpu_torch.ops import corr_rows as crows
from caltech_bifrost_dsp_tpu_torch.ops.corr_triu import (TILE, corr_triu,
                                                         corr_triu_ref)
from caltech_bifrost_dsp_tpu_torch.ops.correlate import (Vis, chan_major,
                                                         correlate_chan_major)
from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build
from caltech_bifrost_dsp_tpu_torch.parallel import mesh as pm
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.runtime.runner import XEngineRunner
from caltech_bifrost_dsp_tpu_torch.verification import golden

SEED = 0xdeadbeef
PFB_TOLERANCE = ("packed bytes vs the float64 plain version: a nibble may "
                 "differ by one code only where the float64 value lies "
                 "within 1e-3 of the rounding threshold, and such cases "
                 "are <= 1e-6 of the codes (max_abs_err is in codes)")
KERNELS = {
    "corr_acc": dict(
        fn=corr_acc, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_acc.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py:123",
        tolerance="exact int32 on j >= i"),
    "corr_acc_cached": dict(
        fn=corr_acc, counter="cached_launches", route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_acc.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py:267",
        tolerance="exact int32 on j >= i; every plane bit-identical to "
                  "corr_acc's"),
    "corr_blk": dict(
        fn=cblk.corr_blk, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_acc.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py:402",
        tolerance="exact int32 on the 128-input tiles with tile(j) >= "
                  "tile(i); tiles below the diagonal stay zero"),
    "corr_rows": dict(
        fn=crows.corr_rows, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_rows.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_rows.py:82",
        tolerance="exact int32 on the 128-input tiles with tile(j) >= "
                  "tile(i); tiles below the diagonal stay zero"),
    "corr_triu": dict(
        fn=corr_triu, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_triu.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_triu.py:69",
        tolerance="exact int32 on the 128-input tiles with tile(j) >= "
                  "tile(i); tiles below the diagonal stay zero"),
    "beamform_products": dict(
        fn=bf.beamform_products, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/"
               "beamform_products.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/beamform_fused.py:161",
        tolerance="rtol 1e-4, atol 1e-4 * max|plain|; VLBI exact with "
                  "integer gains"),
    "subsel_gather": dict(
        fn=cs.corr_subsel, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/"
               "subsel_gather.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/subsel_gather.py:162",
        also_replaces=[
            "caltech_bifrost_dsp_tpu/ops/pallas/subsel_gather.py:221",
            "caltech_bifrost_dsp_tpu/ops/pallas/subsel_gather.py:82"],
        tolerance="exact int32"),
    "pfb_direct": dict(
        fn=pfb_fused.pfb_direct, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/"
               "pfb_quantize.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/pfb_fused.py:434",
        tolerance=PFB_TOLERANCE),
    "pfb_factored": dict(
        fn=pfb_fused.pfb_factored, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/"
               "pfb_quantize.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/pfb_fused.py:383",
        tolerance=PFB_TOLERANCE),
}
#: the fused correlator's entry that ``corr_acc(unpack_cache=None)``, and so
#: the main path, launches; the other schedule runs in the schedules run
DEFAULT_CORR = "corr_acc_cached" if UNPACK_CACHE_DEFAULT else "corr_acc"
#: why no kernel has a library time: no single PyTorch call computes its
#: function on its inputs (4+4-bit packed bytes in, or a fused chain out)
NO_LIBRARY = None
#: the card's published peaks (H100 SXM data sheet, dense): memory rate,
#: int8 tensor-core rate, float32 rate outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "fp32": 67e12}
#: the FX operating point: int8 ADC, one slow dump after three windows
FX_CFG = LWA352.replace(adc_dtype="int8", acc_len_slow=7200)
FENGINE_NCHAN, FENGINE_NSPEC = 4096, 240
TONE_CHAN = 77
# the production selection plus one malformed pair (stand 400 of 352)
PAIRS = np.concatenate([
    cs.baselines_to_inputs(cs.production_baselines(LWA352.nvis_out,
                                                   LWA352.nstand)),
    cs.baselines_to_inputs([[[400, 0], [3, 1]]])]).astype(np.int32)
#: the driver path: three windows and one slow dump at full width
DRIVER_CFG = LWA352.replace(acc_len_slow=7200)
DRIVER_ENGINES = {
    "pallas_triu": dict(corr_engine="pallas_triu", subsel_engine="pallas",
                        bf_engine="pallas"),
    "TPU_ENGINES": dict(TPU_ENGINES),
}
#: the driver's selection: production, the last entry malformed (stand 400)
DRIVER_BASELINES = (cs.production_baselines(LWA352.nvis_out, LWA352.nstand)
                    [:-1] + [[[400, 0], [3, 1]]])
SYNC_TIME = 1_700_000_000


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def power_close(got, want) -> bool:
    """The reference's beam gate: rtol 1e-4, atol 1e-4 * max|truth|."""
    return bool(torch.allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max())))


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bound(nbyte: float, nop: float, kind: str) -> dict:
    """The least time the card could take: every input read once and every
    output written once over the memory rate, or the operations over the
    peak rate of their type, whichever is larger."""
    t_bytes = nbyte / HBM_BYTES_S * 1e3
    t_ops = nop / PEAK_OPS_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": NO_LIBRARY}


def corr_bound(nchan: int, ntime: int, ni: int, tile: int,
               nplane_read: int, nplane_written: int) -> dict:
    """A correlator call: the packed block in, ``nplane_*`` int32 planes'
    valid tiles (tile(j) >= tile(i)) in and out; 4 real multiply-adds per
    time sample, channel and input pair i <= j on the int8 tensor cores."""
    nt = -(-ni // tile)
    valid = sum(min(tile, ni - a * tile) * min(tile, ni - b * tile)
                for a in range(nt) for b in range(a, nt))
    nbyte = nchan * ntime * ni + (nplane_read + nplane_written) * 4 * \
        nchan * valid
    return bound(nbyte, 8 * nchan * ntime * ni * (ni + 1) / 2, "int8")


def pfb_bound(adc, nspec: int, nchan: int, ntap: int) -> dict:
    """The channelizer: ADC in, packed bytes out; the FIR's 2 * ntap
    operations per sample and a real FFT's 2.5 log2(L) (the least count
    for the transform, whatever the kernel does) in float32."""
    L, ni = 2 * nchan, adc.shape[1]
    nbyte = adc.numel() * adc.element_size() + ni * nspec * nchan
    return bound(nbyte, nspec * ni * L * (2 * ntap + 2.5 * math.log2(L)),
                 "fp32")


def phase_kernels(dev, card: str, results: dict) -> None:
    """Each kernel against its plain version at the production shapes."""
    cfg = LWA352
    nchan, ni, ntime = cfg.nchan, cfg.ninput, cfg.acc_len
    g = torch.Generator(device=dev).manual_seed(SEED)
    packed = torch.randint(0, 256, (ntime, nchan, ni), generator=g,
                           device=dev, dtype=torch.uint8)
    xc = chan_major(packed, "tci")
    upper = torch.triu(torch.ones((ni, ni), dtype=torch.bool, device=dev))

    def rand_planes():
        return [torch.randint(-2 ** 20, 2 ** 20, (nchan, ni, ni),
                              generator=g, device=dev, dtype=torch.int32)
                for _ in range(4)]

    err = 0.0
    for flags in [(True, False, False), (False, False, False),
                  (False, True, True), (False, True, False),
                  (True, True, False), (True, True, True)]:
        init = rand_planes()
        want = [p.clone() for p in init]
        corr_acc_ref(xc, Vis(*want[:2]), Vis(*want[2:]), *flags)
        got = init
        corr_acc(packed, Vis(*got[:2]), Vis(*got[2:]), *flags,
                 unpack_cache=False)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            check(torch.equal(a[:, upper], b[:, upper]),
                  f"corr_acc != plain on j >= i, flags {flags}")
            err = max(err, max_abs(a[:, upper], b[:, upper]))
        print(f"corr_acc flags {flags}: exact int32 on j >= i", flush=True)
    del want
    state = rand_planes()
    fast, slow = Vis(*state[:2]), Vis(*state[2:])
    ms = cuda_ms(lambda: corr_acc(packed, fast, slow, False, True, False,
                                  unpack_cache=False), 5)
    plain_ms = cuda_ms(lambda: corr_acc_ref(xc, fast, slow, False, True,
                                            False), 2)
    # flags (False, True, False): all four planes read and written
    results["corr_acc"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               **corr_bound(nchan, ntime, ni, 64, 4, 4))
    phase_cached(dev, card, results, packed, xc, upper, rand_planes,
                 plain_ms)
    int_mm_yardstick(card, packed)

    pairs = torch.from_numpy(PAIRS).to(dev)
    got = cs.corr_subsel(fast, pairs, cfg.nchan_sum)
    want = cs.corr_subsel_ref(fast, pairs, cfg.nchan_sum)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        check(torch.equal(a, b), "subsel != plain")
    print("subsel_gather: exact int32, malformed pair included", flush=True)
    nvis, nco = pairs.shape[0], nchan // cfg.nchan_sum
    results["subsel_gather"].update(
        **bound(8 * nvis * (nchan + nco + 1), 2 * nvis * nchan, "fp32"),
        max_abs_err=max(max_abs(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: cs.corr_subsel(fast, pairs, cfg.nchan_sum), 20),
        plain_ms=cuda_ms(lambda: cs.corr_subsel_ref(fast, pairs,
                                                    cfg.nchan_sum), 5))
    del fast, slow, state

    err = 0.0
    for kind in ("integer", "float"):
        shape = (nchan, cfg.nbeam, ni)
        if kind == "integer":
            gains = bf.BeamGains(*(torch.randint(-8, 9, shape, generator=g,
                                                 device=dev).float()
                                   for _ in range(2)))
        else:
            gains = bf.BeamGains(*(torch.randn(shape, generator=g,
                                               device=dev)
                                   for _ in range(2)))
        p, v = bf.beamform_products(packed, gains, cfg.ntime_sum)
        wp, wv = bf.beamform_products_ref(xc, gains, cfg.ntime_sum)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(p).all() and torch.isfinite(v).all()),
              "beam products not finite")
        check(power_close(p, wp), f"beam power ({kind} gains) vs plain")
        if kind == "integer":
            check(torch.equal(v, wv), "VLBI (integer gains) not exact")
        else:
            check(power_close(v, wv), "VLBI (float gains) vs plain")
        err = max(err, max_abs(p, wp), max_abs(v, wv))
        rel = max_abs(p, wp) / float(wp.abs().max())
        print(f"beamform_products {kind} gains: power max|err|/max "
              f"{rel:.3e}, VLBI max|err| {max_abs(v, wv):.3e}", flush=True)
    results["beamform_products"].update(
        **bound(packed.numel() + 8 * gains.real.numel() + 4 * p.numel()
                + 4 * v.numel(), 8 * nchan * ntime * cfg.nbeam * ni, "fp32"),
        max_abs_err=err,
        ms=cuda_ms(lambda: bf.beamform_products(packed, gains,
                                                cfg.ntime_sum), 10),
        plain_ms=cuda_ms(lambda: bf.beamform_products_ref(
            xc, gains, cfg.ntime_sum), 3))
    for name in ("corr_acc", "corr_acc_cached", "beamform_products",
                 "subsel_gather"):
        print_kernel(card, name, results[name], "per call at the production "
                     "shape")


def print_kernel(card: str, name: str, r: dict, where: str) -> None:
    print(f"[{card}] {name}: kernel {r['ms']:.3f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms (by "
          f"{r['bound_by']}) {where}", flush=True)


def phase_cached(dev, card, results, packed, xc, upper, rand_planes,
                 plain_ms) -> None:
    """``corr_acc(unpack_cache=True)`` at the production shape (tci and
    cti) and a ragged one: exact against the plain version on j >= i and
    bit-identical to the default kernel on every plane."""
    cfg = LWA352
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    ragged = torch.randint(0, 256, (3, 997, 320), generator=g, device=dev,
                           dtype=torch.uint8)
    cti = packed.permute(1, 0, 2).contiguous()
    err = 0.0
    for blk, layout, ni, flag_sets in [
            (packed, "tci", cfg.ninput, [(True, False, False),
                                         (False, True, False),
                                         (True, True, True)]),
            (cti, "cti", cfg.ninput, [(False, True, True)]),
            (ragged, "cti", 300, [(False, True, False)])]:
        view = chan_major(blk, layout, ni)
        nchan = view.shape[0]
        up = torch.triu(torch.ones((ni, ni), dtype=torch.bool, device=dev))
        for flags in flag_sets:
            init = [torch.randint(-2 ** 20, 2 ** 20, (nchan, ni, ni),
                                  generator=g, device=dev, dtype=torch.int32)
                    for _ in range(4)]
            want = [p.clone() for p in init]
            corr_acc_ref(view, Vis(*want[:2]), Vis(*want[2:]), *flags)
            default = [p.clone() for p in init]
            corr_acc(blk, Vis(*default[:2]), Vis(*default[2:]), *flags,
                     layout=layout, unpack_cache=False)
            corr_acc(blk, Vis(*init[:2]), Vis(*init[2:]), *flags,
                     layout=layout, unpack_cache=True)
            torch.cuda.synchronize()
            for a, b, d in zip(init, want, default):
                check(torch.equal(a[:, up], b[:, up]),
                      f"corr_acc cached != plain on j >= i, {layout} {ni} "
                      f"inputs, flags {flags}")
                check(torch.equal(a, d), "corr_acc cached not bit-identical "
                      f"to the default kernel, {layout} flags {flags}")
                err = max(err, max_abs(a[:, up], b[:, up]))
            del init, want, default
        print(f"corr_acc unpack_cache {layout} {ni} inputs x {nchan} "
              f"channels: exact int32 on j >= i, bit-identical to the "
              f"default kernel", flush=True)
    del cti
    state = rand_planes()
    fast, slow = Vis(*state[:2]), Vis(*state[2:])
    ms = cuda_ms(lambda: corr_acc(packed, fast, slow, False, True, False,
                                  unpack_cache=True), 5)
    results["corr_acc_cached"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **corr_bound(cfg.nchan, cfg.acc_len, cfg.ninput, 64, 4, 4))


def int_mm_yardstick(card: str, packed, nchan: int = 4) -> None:
    """Contraction only: ``torch._int_mm`` on unpacked int8 planes of
    ``nchan`` channels, the four real products re.re, im.im, im.re, re.im
    of the full 704 x 704 matrix each, scaled to the block's channels.  No
    unpack, no triangle, no accumulator algebra: a yardstick for the
    tensor-core contraction, not a library version of the kernel."""
    x = packed[:, :nchan].permute(1, 2, 0).to(torch.int16)   # [c, i, t]
    re = (((x >> 4) ^ 8) - 8).to(torch.int8).contiguous()
    im = (((x & 15) ^ 8) - 8).to(torch.int8).contiguous()

    def products():
        for c in range(nchan):
            for a, b in ((re, re), (im, im), (im, re), (re, im)):
                torch._int_mm(a[c], b[c].t())

    ms = cuda_ms(products, 5) * packed.shape[1] / nchan
    print(f"[{card}] yardstick, contraction only: torch._int_mm, 4 real "
          f"products of [704, 2400] x [2400, 704] int8 per channel, timed "
          f"on {nchan} channels and scaled to {packed.shape[1]}: {ms:.3f} "
          f"ms (no unpack, full matrix, no epilogue)", flush=True)


def matmul_yardstick(card: str, nrow: int, L: int, part: int = 8) -> None:
    """Contraction only: one ``torch.matmul`` of [rows, L] x [L, L] in
    float32 and in float64 (the direct channelizer's DFT as one product of
    the full depth, Re and Im columns side by side), timed on 1 / ``part``
    of the rows and scaled.  No FIR, no fold, no requantizer."""
    n = nrow // part
    for dtype in (torch.float32, torch.float64):
        a = torch.randn((n, L), device="cuda", dtype=dtype)
        b = torch.randn((L, L), device="cuda", dtype=dtype)
        ms = cuda_ms(lambda: torch.matmul(a, b), 5) * nrow / n
        print(f"[{card}] yardstick, contraction only: torch.matmul "
              f"{str(dtype).split('.')[-1]} [{nrow}, {L}] x [{L}, {L}], "
              f"timed on {n} rows and scaled: {ms:.3f} ms (no FIR, no "
              f"requantizer)", flush=True)
        del a, b


def golden_windows(cfg, nwin: int) -> list:
    """The first ``nwin`` golden windows, uint8 [acc_len, nchan, nstand,
    npol] each."""
    return list(golden.generate_input_blocks(
        nwin * cfg.acc_len, cfg.nchan, cfg.nstand, cfg.npol, cfg.acc_len))


def run_geometry(dev, cfg, blocks: list, gains_np, window_s: list) -> None:
    """Drive XEngineRunner over golden windows; hold every product against
    the plain versions on the card (anchored to the host truth on 4
    channels per window)."""
    ni = cfg.ninput
    nwin = len(blocks)
    gains = bf.BeamGains(*(torch.from_numpy(x).to(dev) for x in gains_np))
    pairs = torch.from_numpy(PAIRS).to(dev)
    runner = XEngineRunner(cfg, "cuda", gains=gains, subsel_pairs=PAIRS)

    def stream():
        for w, block in enumerate(blocks):
            for k in range(cfg.acc_len // cfg.ntime_gulp):
                gulp = block[k * cfg.ntime_gulp:(k + 1) * cfg.ntime_gulp]
                yield ((w * cfg.acc_len + k * cfg.ntime_gulp),
                       gulp.reshape(cfg.ntime_gulp, cfg.nchan, ni))

    it = runner.run(stream())
    slow_plain = None
    for w, block in enumerate(blocks):
        t0 = time.perf_counter()
        prod = next(it)
        window_s.append(time.perf_counter() - t0)
        packed = torch.from_numpy(block.reshape(cfg.acc_len, cfg.nchan,
                                                ni)).to(dev)
        xc = chan_major(packed, "tci")
        plain = correlate_chan_major(xc)
        hvr, hvi = golden.host_corr_int32(block[:, :4])
        check(np.array_equal(plain.real[:4].cpu().numpy(), hvr)
              and np.array_equal(plain.imag[:4].cpu().numpy(), hvi),
              "plain correlator vs host truth on 4 channels")
        fast = dense_vis(runner.state.vis_fast, cfg)
        check(torch.equal(fast.real, plain.real)
              and torch.equal(fast.imag, plain.imag),
              f"{cfg.nchan}c window {w}: fast dump vs plain")
        want = cs.corr_subsel_ref(plain, pairs, cfg.nchan_sum)
        check(np.array_equal(prod["subsel"][0], want.real.cpu().numpy())
              and np.array_equal(prod["subsel"][1], want.imag.cpu().numpy()),
              f"{cfg.nchan}c window {w}: subsel vs plain")
        wp, wv = bf.beamform_products_ref(xc, gains, cfg.ntime_sum)
        check(np.array_equal(prod["vlbi"], wv.cpu().numpy()),
              f"{cfg.nchan}c window {w}: VLBI not exact")
        check(power_close(torch.from_numpy(prod["bf_power"]), wp.cpu()),
              f"{cfg.nchan}c window {w}: beam power vs plain")
        slow_plain = plain if slow_plain is None else slow_plain + plain
        print(f"[{cfg.nchan}c] window {w}: fast, subsel, VLBI exact; power "
              f"within rtol 1e-4 ({window_s[-1]:.3f} s in the runner)",
              flush=True)
        del packed, xc, fast, plain
    check(next(it, None) is None, "runner yielded more calls than windows")
    check("vis_slow" in prod, f"{cfg.nchan}c: no slow dump")
    sr, si = prod["vis_slow"]
    check(np.array_equal(sr, slow_plain.real.cpu().numpy())
          and np.array_equal(si, slow_plain.imag.cpu().numpy()),
          f"{cfg.nchan}c: slow dump vs plain")
    print(f"[{cfg.nchan}c] slow dump after {nwin} windows: exact", flush=True)


def zero_counts() -> None:
    for spec in KERNELS.values():
        setattr(spec["fn"], spec.get("counter", "launches"), 0)


def read_counts() -> dict:
    return {name: getattr(spec["fn"], spec.get("counter", "launches"))
            for name, spec in KERNELS.items()}


def pfb_gate(packed, adc, window, nchan: int, ntap: int, scale,
             fast: bool = False, what: str = "") -> int:
    """Kernel bytes vs the float64 plain channelizer (run in chunks of
    inputs: its FIR alone would be 5.2 GB at 704 inputs).  Every differing nibble
    must be a one-code step at a threshold; their count must be <= 1e-6 of
    the codes (1e-5 for bf16 operands).  Returns that count."""
    tolerated = pfb.assert_packed_matches_ref(packed, adc, window, nchan,
                                              ntap, scale, fast)
    ncode = 2 * packed.numel()
    frac = tolerated / ncode
    print(f"{what}: pfb gate {tolerated} threshold cases of {ncode} codes "
          f"({frac:.2e})", flush=True)
    check(frac <= (1e-5 if fast else 1e-6), f"{what}: pfb gate {frac:.2e}")
    return tolerated


def code_histogram(packed, what: str) -> None:
    """A noise window's codes must not be degenerate: at most 5% saturated
    (-8 or 7) and at least 12 of the 16 codes in use."""
    counts = torch.zeros(16, dtype=torch.int64, device=packed.device)
    for nib in (packed >> 4, packed & 0xF):
        counts += torch.bincount(nib.flatten().to(torch.int32),
                                 minlength=16)
    sat = float(counts[7] + counts[8]) / float(counts.sum())
    used = int((counts > 0).sum())
    print(f"{what}: {sat:.4f} of codes saturated, {used} of 16 codes used",
          flush=True)
    check(sat <= 0.05 and used >= 12, f"{what}: degenerate code histogram")


def fx_scale_for(adc: np.ndarray, cfg) -> float:
    """The requant gain that puts the pre-quantization rms near 2.5 codes,
    from the first 8 inputs."""
    x = torch.from_numpy(adc[:, :8].copy())
    re, _ = pfb.pfb_prequant_ref(x, pfb.pfb_window(cfg.nchan, cfg.pfb_ntap),
                                 cfg.nchan, cfg.pfb_ntap, 1.0)
    return float(np.float32(2.5 / float(re.std())))


def adc_windows(cfg, nwin: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    n = cfg.acc_len * 2 * cfg.nchan
    return [rng.integers(-90, 91, (n, cfg.ninput), dtype=np.int8)
            for _ in range(nwin)]


def drive_fx(dev, cfg, windows: list, gains_np, quant_scale: float,
             window_s: list):
    """One FX path run: counts to 0, XEngineRunner in FX mode over the
    windows, counts read.  Records per window the ADC with its FIR history,
    the products and a copy of the fast accumulator."""
    zero_counts()
    gains = bf.BeamGains(*(torch.from_numpy(x[:cfg.nchan]).to(dev)
                           for x in gains_np))
    runner = XEngineRunner(cfg, dev, gains=gains, subsel_pairs=PAIRS,
                           fx=True, quant_scale=quant_scale)
    g = cfg.ntime_gulp * 2 * cfg.nchan

    def stream():
        for w, adc in enumerate(windows):
            for k in range(cfg.acc_len // cfg.ntime_gulp):
                yield (w * cfg.acc_len + k * cfg.ntime_gulp,
                       adc[k * g:(k + 1) * g])

    it = runner.run(stream())
    records = []
    for adc in windows:
        ext = np.concatenate([runner.adc_tail, adc])
        t0 = time.perf_counter()
        prod = next(it)
        window_s.append(time.perf_counter() - t0)
        fast = Vis(runner.state.vis_fast.real.clone(),
                   runner.state.vis_fast.imag.clone())
        records.append((ext, prod, fast))
    check(next(it, None) is None, "FX runner yielded more calls than windows")
    torch.cuda.synchronize()
    return records, gains, runner.scale, read_counts()


def check_fx(dev, cfg, records, gains, scale, label: str,
             noise: bool = True) -> list:
    """(a) the channelizer's bytes under the gate, (b) fast, subselection,
    VLBI (integer gains) and slow exact and power within rtol 1e-4 against
    the plain X/B versions on those bytes, (c) the code histogram of noise
    windows.  Returns the kernel's bytes per window (input-major)."""
    window = torch.from_numpy(pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)).to(dev)
    pairs = torch.from_numpy(PAIRS).to(dev)
    slow_plain, out = None, []
    for w, (ext, prod, fast) in enumerate(records):
        what = f"[FX {label}] window {w}"
        adc = torch.from_numpy(ext).to(dev)
        packed = pfb_fused.pfb_direct(adc, window, cfg.nchan, cfg.pfb_ntap,
                                      scale)
        pfb_gate(packed, adc, window, cfg.nchan, cfg.pfb_ntap, scale,
                 what=what)
        if noise:
            code_histogram(packed, what)
        xc = chan_major(packed.permute(1, 2, 0).contiguous(), "tci")
        plain = correlate_chan_major(xc)
        dense = dense_vis(fast, cfg)
        check(torch.equal(dense.real, plain.real)
              and torch.equal(dense.imag, plain.imag),
              f"{what}: fast dump vs plain on the kernel's bytes")
        want = cs.corr_subsel_ref(plain, pairs, cfg.nchan_sum)
        check(np.array_equal(prod["subsel"][0], want.real.cpu().numpy())
              and np.array_equal(prod["subsel"][1], want.imag.cpu().numpy()),
              f"{what}: subsel vs plain")
        wp, wv = bf.beamform_products_ref(xc, gains, cfg.ntime_sum)
        check(np.array_equal(prod["vlbi"], wv.cpu().numpy()),
              f"{what}: VLBI not exact")
        check(power_close(torch.from_numpy(prod["bf_power"]), wp.cpu()),
              f"{what}: beam power vs plain")
        slow_plain = plain if slow_plain is None else slow_plain + plain
        print(f"{what}: fast, subsel, VLBI exact; power within rtol 1e-4",
              flush=True)
        out.append(packed)
        del adc, xc, plain, dense
    check("vis_slow" in prod, f"[FX {label}]: no slow dump")
    sr, si = prod["vis_slow"]
    check(np.array_equal(sr, slow_plain.real.cpu().numpy())
          and np.array_equal(si, slow_plain.imag.cpu().numpy()),
          f"[FX {label}]: slow dump vs plain")
    print(f"[FX {label}] slow dump after {len(records)} windows: exact",
          flush=True)
    return out


def run_fx_path(dev, gains_np, window_s: list) -> tuple[dict, float]:
    """The FX path: 3 int8 windows + slow dump at 192 channels, one window
    at 184, one with float32 ADC, one tone window.  Returns the launch
    counts summed over the runs and the requant gain."""
    cfg = FX_CFG
    windows = adc_windows(cfg, 3, SEED)
    runs = []

    def run(cfg_r, wins, label, noise=True, qs=None):
        if qs is None:
            qs = fx_scale_for(wins[0], cfg_r)
        print(f"[FX {label}] requant gain {qs:.6g} (pre-quantization rms "
              f"~2.5 codes on noise)", flush=True)
        records, gains, scale, counts = drive_fx(dev, cfg_r, wins, gains_np,
                                                 qs, window_s)
        for name in ("pfb_direct", DEFAULT_CORR, "beamform_products",
                     "subsel_gather"):
            check(counts[name] > 0, f"[FX {label}] {name} not launched")
        print(f"[FX {label}] kernel launches: {counts}", flush=True)
        runs.append(counts)
        return check_fx(dev, cfg_r, records, gains, scale, label, noise), \
            records

    bytes8, rec8 = run(cfg, windows, "192c int8")
    cfg184 = LWA352.replace(nchan=184, adc_dtype="int8", acc_len_slow=cfg.acc_len)
    run(cfg184, adc_windows(cfg184, 1, SEED + 2), "184c int8")
    cfg32 = cfg.replace(adc_dtype="float32", acc_len_slow=cfg.acc_len)
    bytes32, rec32 = run(cfg32, [windows[0].astype(np.float32)], "192c f32")
    check(torch.equal(bytes32[0], bytes8[0]),
          "f32 ADC bytes differ from the int8 run's on the same values")
    check(all(torch.equal(a, b) for a, b in zip(rec32[0][2], rec8[0][2])),
          "f32 ADC fast dump differs from the int8 run's")
    print("[FX 192c f32] packed bytes and fast dump equal the int8 run's",
          flush=True)
    del bytes8, bytes32, rec8, rec32
    cfgt = cfg.replace(acc_len_slow=cfg.acc_len)
    src = ADCSource(cfgt, mode="tone", tone_chan=TONE_CHAN, amplitude=32.0)
    tone = np.concatenate([src.gulp(i) for i in range(
        cfgt.acc_len // cfgt.ntime_gulp)])
    _, rect = run(cfgt, [tone], f"tone {TONE_CHAN}", noise=False,
                  qs=fx_scale_for(windows[0], cfg))
    sr, _ = rect[-1][1]["vis_slow"]
    autos = sr[:, 0, 0].astype(np.float64)
    others = np.delete(autos, [TONE_CHAN - 1, TONE_CHAN, TONE_CHAN + 1])
    check(int(autos.argmax()) == TONE_CHAN
          and others.max() < 0.05 * autos[TONE_CHAN]
          and np.allclose(sr[TONE_CHAN], autos[TONE_CHAN], rtol=0.01),
          f"tone not in channel {TONE_CHAN}")
    print(f"[FX tone] the tone lands in channel {TONE_CHAN} (auto "
          f"{autos[TONE_CHAN]:.0f}, largest elsewhere {others.max():.0f})",
          flush=True)
    total = {name: sum(r[name] for r in runs) for name in KERNELS}
    return total, fx_scale_for(windows[0], cfg)


def run_fengine(dev, card: str, results: dict) -> dict:
    """The F-engine path: channelize_pack_imajor at 4096 channels x 704
    inputs x 240 spectra of int8 ADC (1.4 GB; depth cut from 2400 spectra
    for the time limit), the factored kernel against the plain version."""
    cfg = LWA352.replace(nchan=FENGINE_NCHAN, adc_dtype="int8")
    ntap, L = cfg.pfb_ntap, 2 * FENGINE_NCHAN
    rng = np.random.default_rng(SEED + 3)
    adc_np = rng.integers(-90, 91, ((FENGINE_NSPEC + ntap - 1) * L,
                                    cfg.ninput), dtype=np.int8)
    qs = fx_scale_for(adc_np, cfg)
    adc = torch.from_numpy(adc_np).to(dev)
    del adc_np
    window = torch.from_numpy(pfb.pfb_window(FENGINE_NCHAN, ntap)).to(dev)
    zero_counts()
    packed = pfb.channelize_pack_imajor(adc, window, cfg, qs)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["pfb_factored"] > 0, "F-engine: pfb_factored not launched")
    print(f"[F-engine] kernel launches: {counts}", flush=True)
    check(packed.shape == (cfg.ninput, FENGINE_NSPEC, FENGINE_NCHAN),
          "F-engine: packed shape")
    what = f"[F-engine {FENGINE_NCHAN}c x {cfg.ninput} x {FENGINE_NSPEC}]"
    ntol = pfb_gate(packed, adc, window, FENGINE_NCHAN, ntap, qs, what=what)
    code_histogram(packed, what)
    ms = cuda_ms(lambda: pfb_fused.pfb_factored(adc, window, FENGINE_NCHAN,
                                                ntap, qs), 3)
    plain_ms = cuda_ms(lambda: pfb.pfb_quantize_packed_ref(
        adc, window, FENGINE_NCHAN, ntap, qs), 1)
    results["pfb_factored"].update(
        max_abs_err=1.0 if ntol else 0.0, ms=ms, plain_ms=plain_ms,
        **pfb_bound(adc, FENGINE_NSPEC, FENGINE_NCHAN, ntap))
    msps = FENGINE_NSPEC * L / (ms * 1e-3) / 1e6
    print(f"[{card}] pfb_factored at {FENGINE_NCHAN} channels x "
          f"{cfg.ninput} inputs x {FENGINE_NSPEC} spectra: kernel {ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms, bound "
          f"{results['pfb_factored']['bound_ms']:.3f} ms (by "
          f"{results['pfb_factored']['bound_by']}); {msps:.1f} Msamples/s "
          f"per input "
          f"(F-engine bar fs = {cfg.fs_hz / 1e6:.0f} Msamples/s: "
          f"{msps / (cfg.fs_hz / 1e6):.3f}x)", flush=True)
    return counts


def phase_pfb_direct(dev, card: str, results: dict) -> None:
    """The direct channelizer kernel against its plain version at the
    production shape (704 inputs x 2400 spectra x 192 channels, int8),
    float32 and bf16 operands, and per-channel scale."""
    cfg = FX_CFG
    ntap, L = cfg.pfb_ntap, 2 * cfg.nchan
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    adc = torch.randint(-90, 91, ((cfg.acc_len + ntap - 1) * L, cfg.ninput),
                        generator=g, device=dev, dtype=torch.int8)
    window = torch.from_numpy(pfb.pfb_window(cfg.nchan, ntap)).to(dev)
    qs = fx_scale_for(adc[:, :8].cpu().numpy(), cfg)
    per_chan = (torch.rand(cfg.nchan, generator=g, device=dev) * 0.6
                + 0.7) * qs
    ntol = 0
    for scale, fast, what in [(qs, False, "float32"),
                              (per_chan, False, "float32, per-channel"),
                              (qs, True, "bf16")]:
        packed = pfb_fused.pfb_direct(adc, window, cfg.nchan, ntap, scale,
                                      fast)
        torch.cuda.synchronize()
        n = pfb_gate(packed, adc, window, cfg.nchan, ntap, scale, fast,
                     what=f"pfb_direct {what}")
        ntol += 0 if fast else n
    results["pfb_direct"].update(
        **pfb_bound(adc, cfg.acc_len, cfg.nchan, ntap),
        max_abs_err=1.0 if ntol else 0.0,
        ms=cuda_ms(lambda: pfb_fused.pfb_direct(adc, window, cfg.nchan, ntap,
                                                qs), 5),
        plain_ms=cuda_ms(lambda: pfb.pfb_quantize_packed_ref(
            adc, window, cfg.nchan, ntap, qs), 2))
    print_kernel(card, "pfb_direct", results["pfb_direct"],
                 "per 2400-spectra window at 704 inputs")
    matmul_yardstick(card, cfg.ninput * cfg.acc_len, L)


def phase_triu(dev, card: str, results: dict) -> None:
    """The three gulp correlators against their plain versions."""
    phase_gulp(dev, card, results, "corr_triu", corr_triu, corr_triu_ref,
               TILE)
    phase_gulp(dev, card, results, "corr_blk", cblk.corr_blk,
               cblk.corr_blk_ref, cblk.TILE)
    phase_gulp(dev, card, results, "corr_rows", crows.corr_rows,
               crows.corr_rows_ref, crows.TILE)


def phase_gulp(dev, card: str, results: dict, name: str, fn, ref,
               tile_size: int) -> None:
    """A gulp correlator against its plain version: production shape in
    both layouts, and a ragged shape (300 inputs, 997 spectra, padded
    cti).  Exact int32 on the upper tiles, zero below them."""
    cfg = LWA352
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    err = 0.0
    for ntime, nchan, ni, layout, pad in [
            (cfg.acc_len, cfg.nchan, cfg.ninput, "tci", 0),
            (cfg.acc_len, cfg.nchan, cfg.ninput, "cti", 64),
            (997, 3, 300, "cti", 20)]:
        shape = ((ntime, nchan, ni) if layout == "tci"
                 else (nchan, ntime, ni + pad))
        packed = torch.randint(0, 256, shape, generator=g, device=dev,
                               dtype=torch.uint8)
        got = fn(packed, layout, ni)
        want = ref(chan_major(packed, layout, ni))
        torch.cuda.synchronize()
        tile = torch.arange(ni, device=dev) // tile_size
        valid = tile[:, None] <= tile[None, :]
        for a, b in zip(got, want):
            check(torch.equal(a[:, valid], b[:, valid]),
                  f"{name} != plain on the upper tiles ({ni} inputs, "
                  f"{ntime} spectra, {layout})")
            check(not a[:, ~valid].any(), f"{name} wrote below the "
                  "diagonal tiles")
            err = max(err, max_abs(a[:, valid], b[:, valid]))
        print(f"{name} {ni} inputs x {nchan} channels x {ntime} spectra "
              f"{layout}: exact int32 on the upper {tile_size}-tiles", flush=True)
        if ni == cfg.ninput and layout == "tci":
            xc = chan_major(packed, layout, ni)
            results[name].update(
                ms=cuda_ms(lambda: fn(packed, layout, ni), 5),
                plain_ms=cuda_ms(lambda: ref(xc), 2),
                **corr_bound(nchan, ntime, ni, tile_size, 0, 2))
        del got, want
    results[name]["max_abs_err"] = err
    print_kernel(card, name, results[name], "per 2400-spectra window at 704 "
                 "inputs x 192 channels")


class GoldenSource(SyntheticSource):
    """The golden stream gulp by gulp from pre-generated windows, for the
    driver's zero-copy ingest (``fill_into``)."""

    def __init__(self, cfg, blocks):
        super().__init__(cfg)
        g = cfg.ntime_gulp
        self.gulps = [b.reshape(-1, cfg.nchan, cfg.ninput)[k:k + g]
                      for b in blocks for k in range(0, len(b), g)]

    def fill_into(self, dest):
        i = self._fill_i
        self._fill_i += 1
        dest.reshape(self.gulps[i].shape)[...] = self.gulps[i]
        return i * self.cfg.ntime_gulp

    def stream(self, ngulp: int, seq0: int = 0):
        for i in range(ngulp):
            yield seq0 + i * self.cfg.ntime_gulp, self.gulps[i]


class Receiver(threading.Thread):
    """A loopback UDP receiver: every datagram until stopped."""

    def __init__(self):
        super().__init__(daemon=True)
        self.sock = sink.udp_rx_socket("127.0.0.1", 0, rcvbuf_mb=256,
                                       timeout_s=0.2)
        force = getattr(socket, "SO_RCVBUFFORCE", None)
        if force is not None:
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, force, 256 << 20)
            except PermissionError:
                pass  # capped at the host's rmem_max; the size is printed
        self.rcvbuf = self.sock.getsockopt(socket.SOL_SOCKET,
                                           socket.SO_RCVBUF)
        self.addr = self.sock.getsockname()
        self.pkts = []
        self.done = threading.Event()

    def run(self):
        while True:
            try:
                self.pkts.append(self.sock.recv(65536))
            except TimeoutError:
                if self.done.is_set():
                    return

    def stop(self) -> list:
        self.done.set()
        self.join()
        self.sock.close()
        return self.pkts


def driver_truth(dev, cfg, blocks, gains, pairs) -> tuple[list, tuple]:
    """Plain products of each driver window on the card (anchored to the
    host truth on 4 channels) and the plain slow dump over all of them."""
    gr, gi = (x.cpu().numpy() for x in gains)
    truth, slow = [], None
    for w, block in enumerate(blocks):
        packed = torch.from_numpy(block.reshape(cfg.acc_len, cfg.nchan,
                                                cfg.ninput)).to(dev)
        xc = chan_major(packed, "tci")
        plain = correlate_chan_major(xc)
        hvr, hvi = golden.host_corr_int32(block[:, :4])
        check(np.array_equal(plain.real[:4].cpu().numpy(), hvr)
              and np.array_equal(plain.imag[:4].cpu().numpy(), hvi),
              "driver truth: plain correlator vs host on 4 channels")
        sub = cs.corr_subsel_ref(plain, pairs, cfg.nchan_sum)
        wp, wv = bf.beamform_products_ref(xc, gains, cfg.ntime_sum)
        br, bi = golden.host_beams(block[:, :4], gr[:4], gi[:4])
        hv = np.stack([br[:, :2], bi[:, :2]], -1).transpose(2, 0, 1, 3)
        check(np.array_equal(wv[:, :4].cpu().numpy(), hv)
              and power_close(wp[:, :, :4].cpu(), torch.from_numpy(
                  golden.host_power(br, bi, cfg.ntime_sum)).float()),
              "driver truth: plain beams vs host on 4 channels")
        truth.append({"sub": (sub.real.cpu().numpy(),
                              sub.imag.cpu().numpy()),
                      "power": wp.cpu(), "vlbi": wv.cpu().numpy()})
        slow = plain if slow is None else slow + plain
        del packed, xc
    return truth, (slow.real.cpu().numpy(), slow.imag.cpu().numpy())


def command(store, key: str, seq, **kwargs) -> None:
    """One control-plane command through the store (the client's
    envelope)."""
    store.put(key, json.dumps({"cmd": "update", "id": seq,
                               "val": {"kwargs": kwargs}}))


def load_gains(pipe, store, gains_np) -> None:
    """Every (beam, input) calibration gain, then a zero-delay unit-amp
    load of every beam: the active gains equal ``gains_np`` exactly."""
    gr, gi = gains_np
    key = pipe.beam_cmd.command_key
    data = np.empty(2 * gr.shape[0])
    for b in range(gr.shape[1]):
        for i in range(gr.shape[2]):
            data[0::2] = gr[:, b, i]
            data[1::2] = gi[:, b, i]
            command(store, key, f"g{b}.{i}", coeffs={
                "type": "calgains", "input_id": i, "beam_id": b,
                "data": data.tolist()})
    ni = gr.shape[2]
    for b in range(gr.shape[1]):
        command(store, key, f"d{b}", coeffs={
            "type": "beamcoeffs", "beam_id": b, "load_sample": -1,
            "data": {"delays": [0.0] * ni, "amps": [1.0] * ni}})


def decode_streams(cfg, sub_pkts, pb_pkts, ib_pkts, nwin: int):
    """Received packets -> per-window subselection planes (with the
    baselines they carried), power [nbeam//2, nblock, nchan, 4] and VLBI
    [ntime, nchan, 2, 2]."""
    nco = cfg.nchan // cfg.nchan_sum
    subs = {}
    for p in sub_pkts:
        hdr, bl, data = pk.decode_corr_part(p)
        subs.setdefault(hdr.spectra_id, []).append((bl, data))
    windows = []
    for w in range(nwin):
        parts = subs.get(w * cfg.acc_len, [])
        bl = np.concatenate([b for b, _ in parts]) if parts else None
        data = (np.concatenate([d for _, d in parts]) if parts
                else np.zeros((0, nco, 2), np.int32))
        windows.append((bl, data[..., 0].T, data[..., 1].T))
    nblock = nwin * cfg.acc_len // cfg.ntime_sum
    power = np.full((cfg.nbeam // 2, nblock, cfg.nchan, 4), np.nan,
                    np.float32)
    for p in pb_pkts:
        hdr, data = pk.decode_pbeam(p)
        power[hdr.beam - 1, hdr.seq // cfg.ntime_sum] = data[:, 0]
    vlbi = np.full((nwin * cfg.acc_len, cfg.nchan, 2, 2), np.nan,
                   np.float32)
    for p in ib_pkts:
        hdr, data = pk.decode_ibeam(p)
        vlbi[hdr.seq] = data
    return windows, power, vlbi


def packet_digests(streams: dict) -> dict:
    """SHA-256 of each sink's packets, taken in sorted order (loopback UDP
    keeps no order between senders): equal digests mean the same packets
    byte for byte."""
    out = {}
    for name, pkts in streams.items():
        h = hashlib.sha256()
        for p in sorted(bytes(p) for p in pkts):
            h.update(len(p).to_bytes(4, "little"))
            h.update(p)
        out[name] = h.hexdigest()
    return out


def run_driver(dev, card: str, label: str, engines: dict, blocks,
               gains_np, truth, slow, mesh=None) -> tuple[dict, dict, float]:
    """One driver run: launch counts to 0, XEnginePipeline over the
    golden windows with every sink (sharded over ``mesh`` if given),
    counts read, products checked.  Returns the counts, the digest of each
    sink's packets and the run's wall time."""
    cfg = DRIVER_CFG.replace(**engines)
    nwin = len(blocks)
    CommandBlock.reset_instance_counts()
    rx = {name: Receiver() for name in ("subsel", "pbeam", "ibeam")}
    for r in rx.values():
        r.start()
    cor = []
    store = MemoryStore()
    pipe = XEnginePipeline(
        cfg, GoldenSource(cfg, blocks), store=store, sync_time=SYNC_TIME,
        corr_outputs=[sink.CorrFullOutput(cfg, send=cor.append,
                                          use_cor_fmt=True)],
        subsel_outputs=[sink.CorrPartOutput(
            cfg, send=sink.UdpSender(*rx["subsel"].addr))],
        pbeam_outputs=[sink.PBeamOutput(
            cfg, senders={b: sink.UdpSender(*rx["pbeam"].addr)
                          for b in range(cfg.nbeam // 2)})],
        ibeam_outputs=[sink.IBeamOutput(
            cfg, send=sink.UdpSender(*rx["ibeam"].addr))],
        mesh=mesh, device="cuda")
    t0 = time.perf_counter()
    load_gains(pipe, store, gains_np)
    command(store, pipe.subsel_cmd.command_key, "bl",
            baselines=DRIVER_BASELINES)
    print(f"[driver {label}] gains and baselines commanded in "
          f"{time.perf_counter() - t0:.1f} s; receive buffers "
          f"{min(r.rcvbuf for r in rx.values())} B", flush=True)
    ngulp = nwin * cfg.acc_len // cfg.ntime_gulp
    zero_counts()
    t0 = time.perf_counter()
    pipe.run(ngulp, timeout_s=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    sub_pkts, pb_pkts, ib_pkts = (rx[n].stop() for n in
                                  ("subsel", "pbeam", "ibeam"))
    print(f"[driver {label}] kernel launches: {counts}", flush=True)
    correlator = {"pallas_triu": "corr_triu", "pallas_blk": (
        DEFAULT_CORR if mesh is None else "corr_blk")}[engines["corr_engine"]]
    for name in (correlator, "subsel_gather", "beamform_products"):
        check(counts[name] > 0, f"[driver {label}] {name} not launched")
    check((pipe.ndump_fast, pipe.ndump_slow) == (nwin, 1),
          f"[driver {label}] dumps {pipe.ndump_fast} fast, "
          f"{pipe.ndump_slow} slow")
    nbl = cfg.nstand * (cfg.nstand + 1) // 2
    check(len(cor) == nbl, f"[driver {label}] {len(cor)} COR packets")
    cube = pk.cor_scatter_matrix(cor, cfg.nstand, cfg.npol)
    for k, plane in enumerate(slow):
        want = plane.reshape(cfg.nchan, cfg.nstand, cfg.npol, cfg.nstand,
                             cfg.npol).transpose(1, 3, 2, 4, 0)
        check(np.array_equal(cube[..., k], want),
              f"[driver {label}] COR slow dump vs plain")
    digests = packet_digests({"cor": cor, "subsel": sub_pkts,
                              "pbeam": pb_pkts, "ibeam": ib_pkts})
    del cube, cor
    print(f"[driver {label}] COR slow dump ({nbl} packets) scatters to the "
          f"plain slow dump exactly", flush=True)
    npkt = (nwin * -(-cfg.nvis_out // 16), nwin * cfg.nbeam // 2 *
            cfg.acc_len // cfg.ntime_sum, nwin * cfg.acc_len)
    check((len(sub_pkts), len(pb_pkts), len(ib_pkts)) == npkt,
          f"[driver {label}] received {len(sub_pkts)}, {len(pb_pkts)}, "
          f"{len(ib_pkts)} packets of {npkt}")
    windows, power, vlbi = decode_streams(cfg, sub_pkts, pb_pkts, ib_pkts,
                                          nwin)
    bl = np.asarray(DRIVER_BASELINES, np.uint32)
    nb = cfg.acc_len // cfg.ntime_sum
    for w, ((got_bl, sr, si), want) in enumerate(zip(windows, truth)):
        check(got_bl is not None and np.array_equal(got_bl, bl),
              f"[driver {label}] window {w}: subsel baselines")
        check(np.array_equal(sr, want["sub"][0])
              and np.array_equal(si, want["sub"][1]),
              f"[driver {label}] window {w}: subsel vs plain")
        check(np.array_equal(vlbi[w * cfg.acc_len:(w + 1) * cfg.acc_len],
                             want["vlbi"]),
              f"[driver {label}] window {w}: VLBI not exact")
        check(power_close(torch.from_numpy(power[:, w * nb:(w + 1) * nb]),
                          want["power"]),
              f"[driver {label}] window {w}: beam power vs plain")
    print(f"[driver {label}] {len(sub_pkts)} subsel, {len(pb_pkts)} PBEAM, "
          f"{len(ib_pkts)} IBEAM packets over loopback UDP: subsel and VLBI "
          f"exact, power within rtol 1e-4", flush=True)
    ends = [t0] + pipe.dump_times
    per_window = [b - a for a, b in zip(ends, ends[1:])]
    gbps = nwin * cfg.acc_len * cfg.nchan * cfg.ninput * 8 / wall / 1e9
    print(f"[{card}] driver {label}: host time per window (fast dump "
          f"products out of the output thread) "
          + ", ".join(f"{s:.3f} s" for s in per_window)
          + f"; {wall:.3f} s for {nwin} windows and the slow dump = "
          f"{gbps:.2f} Gb/s sustained (real-time bar "
          f"{cfg.input_gbps:.1f} Gb/s)", flush=True)
    return counts, digests, wall


def run_driver_path(dev, card: str, blocks, gains_np) -> tuple:
    """The fourth path: the driver in both engine sets over the same
    golden windows.  Returns the launch counts summed over both runs, the
    plain products the runs were held to (for the mesh driver run) and the
    ``TPU_ENGINES`` run's packet digests and wall time."""
    cfg = DRIVER_CFG
    gains = bf.BeamGains(*(torch.from_numpy(x).to(dev) for x in gains_np))
    pairs = torch.from_numpy(cs.baselines_to_inputs(
        DRIVER_BASELINES).astype(np.int32)).to(dev)
    truth, slow = driver_truth(dev, cfg, blocks, gains, pairs)
    total = {name: 0 for name in KERNELS}
    switch = sys.getswitchinterval()
    # the receivers share the interpreter with the output thread
    sys.setswitchinterval(5e-4)
    try:
        for label, engines in DRIVER_ENGINES.items():
            counts, digests, wall = run_driver(dev, card, label, engines,
                                               blocks, gains_np, truth, slow)
            total = {name: total[name] + counts[name] for name in KERNELS}
    finally:
        sys.setswitchinterval(switch)
    return total, truth, slow, digests, wall


#: the fifth path: mesh shapes over one card, every shard on ``cuda:0``
MESH_SHAPES = ((2, 2), (1, 4))
MESH_CFG = DRIVER_CFG.replace(**TPU_ENGINES)


def gulps_of(dev, cfg, blocks):
    """The golden windows gulp by gulp on the card: (window, first gulp of
    its window, last gulp, packed [ntime_gulp, nchan, ninput])."""
    g, n = cfg.ntime_gulp, cfg.acc_len // cfg.ntime_gulp
    for w, block in enumerate(blocks):
        win = torch.from_numpy(block.reshape(cfg.acc_len, cfg.nchan,
                                             cfg.ninput)).to(dev)
        for k in range(n):
            yield w, k == 0, k == n - 1, win[k * g:(k + 1) * g]


def vis_equal(got: Vis, want: Vis) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def unshard_vis(vis) -> Vis:
    return Vis(*(pm.unshard(p) for p in vis))


def beams_match(got_p, got_v, want_p, want_v, what: str) -> bool:
    """Power and VLBI of a sharded call within the beam gate of the
    unsharded step's; returns whether both are bit-identical."""
    check(power_close(got_p, want_p), f"{what}: beam power vs unsharded")
    check(power_close(got_v, want_v), f"{what}: VLBI vs unsharded")
    return torch.equal(got_p, want_p) and torch.equal(got_v, want_v)


def mesh_xb_unsharded(dev, blocks, gains, pairs) -> tuple[list, Vis]:
    """The X/B configuration's golden windows gulp by gulp through the
    unsharded ``xengine_step``: per call the products (and the dense fast
    dump on dump calls), and the dense slow dump."""
    cfg = MESH_CFG
    state = init_state(cfg, dev)
    ref = []
    for w, first, last, gulp in gulps_of(dev, cfg, blocks):
        state, out = xengine_step(state, gulp, gains, pairs, first, last,
                                  w == 0, cfg)
        ref.append((out, dense_vis(state.vis_fast, cfg) if last else None))
    return ref, dense_vis(state.vis_slow, cfg)


def mesh_xb(dev, blocks, gains, pairs, ref: list, ref_slow: Vis) -> None:
    """The same stream through ``xengine_sharded_state_fn`` on each mesh
    shape, against the unsharded run."""
    cfg = MESH_CFG
    for shape in MESH_SHAPES:
        label = f"[mesh {shape[0]}x{shape[1]}]"
        mesh = pm.make_mesh(*shape, devices=["cuda:0"] * 4)
        before = read_counts()
        steps = {}
        state = pm.zero_sharded_state(cfg, mesh)
        same_bits = True
        for (w, first, last, gulp), (want, want_fast) in zip(
                gulps_of(dev, cfg, blocks), ref):
            key = (first, last, w == 0)
            if key not in steps:
                steps[key] = pm.xengine_sharded_state_fn(cfg, mesh, *key)
            state, out, vlbi = steps[key](state, gulp, gains, pairs)
            what = f"{label} window {w}"
            same_bits &= beams_match(pm.unshard(out.bf_power),
                                     pm.unshard(vlbi), want.bf_power,
                                     want.vlbi, what)
            check((out.vis is not None) == last, f"{what}: vis on a dump "
                  "call only")
            if last:
                check(vis_equal(unshard_vis(out.vis), want_fast),
                      f"{what}: fast dump vs unsharded")
                check(vis_equal(unshard_vis(out.subsel), want.subsel),
                      f"{what}: subsel vs unsharded")
        check(vis_equal(unshard_vis(state[1]), ref_slow),
              f"{label} slow dump vs unsharded")
        torch.cuda.synchronize()
        after = read_counts()
        made = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        check(made.get("corr_blk", 0) > 0, f"{label} corr_blk not launched")
        nshard = shape[0] * shape[1]
        per_shard = {k: v / nshard for k, v in made.items()}
        print(f"{label} {len(blocks)} windows gulp by gulp + slow dump on "
              f"{nshard} shards of cuda:0: fast, slow, subsel equal the "
              f"unsharded step's exactly; power and VLBI within rtol 1e-4, "
              f"bit-identical: {same_bits}; kernel launches {made}, per "
              f"shard {per_shard}", flush=True)


class MeshFx:
    """One FX window with a carried ADC tail through
    ``fx_sharded_state_fn`` at 2x2 against the unsharded ``fx_step``."""

    def __init__(self, dev, qs: float, gains, pairs):
        self.cfg = cfg = FX_CFG.replace(acc_len_slow=FX_CFG.acc_len,
                                        **TPU_ENGINES)
        L = 2 * cfg.nchan
        self.halo = (cfg.pfb_ntap - 1) * L
        g = torch.Generator(device=dev).manual_seed(SEED + 7)
        self.adc = torch.randint(
            -90, 91, (self.halo + cfg.acc_len * L, cfg.ninput), generator=g,
            device=dev, dtype=torch.int8)
        self.window = torch.from_numpy(pfb.pfb_window(
            cfg.nchan, cfg.pfb_ntap)).to(dev)
        self.scale = torch.tensor(qs, device=dev)
        self.dev, self.gains, self.pairs = dev, gains, pairs
        self.mesh = pm.make_mesh(2, 2, devices=["cuda:0"] * 4)

    def sharded_args(self) -> tuple:
        return (self.adc[self.halo:], self.adc[:self.halo], self.window,
                self.scale)

    def unsharded(self) -> None:
        cfg = self.cfg
        state, self.want = fx_step(
            init_state(cfg, self.dev), self.adc, self.window, self.scale,
            self.gains, self.pairs, True, True, True, cfg)
        self.want_fast = dense_vis(state.vis_fast, cfg)
        self.want_bytes = pfb.channelize_pack_imajor(
            self.adc, self.window, cfg, self.scale).permute(1, 2, 0)

    def sharded(self) -> None:
        """Packed bytes after the corner-turn, fast, slow and subsel equal
        to the unsharded step's; beam products within the gate."""
        cfg, mesh, want = self.cfg, self.mesh, self.want
        got = pm.unshard(pm.fx_packed_sharded_fn(cfg, mesh)(
            *self.sharded_args()))
        check(torch.equal(got, self.want_bytes), "[mesh FX 2x2] packed "
              "bytes after the corner-turn vs the unsharded channelizer's")
        del got
        step = pm.fx_sharded_state_fn(cfg, mesh, True, True, True)
        state, out, vlbi = step(pm.zero_sharded_state(cfg, mesh),
                                *self.sharded_args(), self.gains, self.pairs)
        same_bits = beams_match(pm.unshard(out.bf_power), pm.unshard(vlbi),
                                want.bf_power, want.vlbi, "[mesh FX 2x2]")
        check(vis_equal(unshard_vis(out.vis), self.want_fast)
              and vis_equal(unshard_vis(state[1]), self.want_fast),
              "[mesh FX 2x2] fast and slow vs unsharded")
        check(vis_equal(unshard_vis(out.subsel), want.subsel),
              "[mesh FX 2x2] subsel vs unsharded")
        torch.cuda.synchronize()
        print(f"[mesh FX 2x2] one int8 window with the carried tail: packed "
              f"bytes, fast, slow, subsel equal the unsharded fx_step's "
              f"exactly; power and VLBI within rtol 1e-4, bit-identical: "
              f"{same_bits}", flush=True)
        del self.want, self.want_fast, self.want_bytes

    def times(self, card: str) -> None:
        cfg = self.cfg
        state = init_state(cfg, self.dev)
        fx_ms = cuda_ms(lambda: fx_step(
            state, self.adc, self.window, self.scale, self.gains, self.pairs,
            True, True, False, cfg), 5)
        del state
        state = pm.zero_sharded_state(cfg, self.mesh)
        step = pm.fx_sharded_state_fn(cfg, self.mesh, True, True, False)
        mesh_ms = cuda_ms(lambda: step(state, *self.sharded_args(),
                                       self.gains, self.pairs), 5)
        print(f"[{card}] FX window, device time: fx_sharded_state_fn 2x2 on "
              f"one card {mesh_ms:.3f} ms, unsharded fx_step {fx_ms:.3f} ms",
              flush=True)


def mesh_times(dev, card: str, gains, pairs) -> None:
    """Device time per whole-window call of the sharded X/B step on one
    card beside the unsharded step with the same engines."""
    cfg = MESH_CFG
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    packed = torch.randint(0, 256, (cfg.acc_len, cfg.nchan, cfg.ninput),
                           generator=g, device=dev, dtype=torch.uint8)
    state = init_state(cfg, dev)
    ms = {"unsharded": cuda_ms(lambda: xengine_step(
        state, packed, gains, pairs, True, True, False, cfg), 5)}
    del state
    for shape in MESH_SHAPES:
        mesh = pm.make_mesh(*shape, devices=["cuda:0"] * 4)
        state = pm.zero_sharded_state(cfg, mesh)
        step = pm.xengine_sharded_state_fn(cfg, mesh, True, True, False)
        ms[f"{shape[0]}x{shape[1]}"] = cuda_ms(
            lambda: step(state, packed, gains, pairs), 5)
        del state, step
    print(f"[{card}] X/B window (dump call, one 2400-spectra block), device "
          f"time: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()),
          flush=True)


def run_mesh_path(dev, card: str, blocks, gains_np, qs: float, truth, slow,
                  digests: dict, wall: float) -> dict:
    """The fifth path: the sharded programs of ``parallel/mesh.py`` at
    full width with every shard on this card, and the driver over a 2x2
    mesh with every sink.  Returns the path's launch counts."""
    gains = bf.BeamGains(*(torch.from_numpy(x).to(dev) for x in gains_np))
    pairs = torch.from_numpy(PAIRS).to(dev)
    # the unsharded runs come first: their launches are not the path's
    ref, ref_slow = mesh_xb_unsharded(dev, blocks, gains, pairs)
    fx = MeshFx(dev, qs, gains, pairs)
    fx.unsharded()
    zero_counts()
    mesh_xb(dev, blocks, gains, pairs, ref, ref_slow)
    del ref, ref_slow
    fx.sharded()
    programs = read_counts()
    for name in ("corr_blk", "pfb_direct", "beamform_products",
                 "subsel_gather"):
        check(programs[name] > 0, f"[mesh] {name} not launched by the "
              "sharded programs")
    check(programs["corr_acc"] == 0 and programs["corr_acc_cached"] == 0,
          "[mesh] the sharded programs launched the unsharded correlator")
    print(f"[mesh] kernel launches of the sharded programs: {programs}",
          flush=True)
    fx.times(card)
    del fx
    mesh_times(dev, card, gains, pairs)
    vols = pm.collective_volumes(LWA352, 2, 2)
    print("collective_volumes(LWA352, 2, 2): " + json.dumps(vols),
          flush=True)
    check(vols["mesh"]["devices"] == 4 and len(vols["collectives"]) == 4,
          "collective_volumes")

    mesh = pm.make_mesh(2, 2, devices=["cuda:0"] * 4)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        driver, got, mesh_wall = run_driver(
            dev, card, "mesh 2x2", dict(TPU_ENGINES), blocks, gains_np,
            truth, slow, mesh=mesh)
    finally:
        sys.setswitchinterval(switch)
    check(got == digests, f"[driver mesh 2x2] packets differ from the "
          f"unsharded driver run's: {got} vs {digests}")
    print(f"[driver mesh 2x2] COR, subsel, PBEAM and IBEAM packets byte for "
          f"byte those of the unsharded TPU_ENGINES run ({mesh_wall:.3f} s "
          f"against {wall:.3f} s wall)", flush=True)
    return {name: programs[name] + driver[name] for name in KERNELS}


def run_schedules_path(dev, cfg, blocks, slow) -> dict:
    """The two correlator schedules that no engine name selects, each over
    the golden stream through its wrapper: ``corr_acc`` with the
    ``unpack_cache`` that is not the default carries the fast and slow
    accumulators gulp by gulp over the three windows, ``corr_rows``
    correlates each gulp and the results are summed.  Both slow sums must
    equal the plain slow dump.  Returns the counts."""
    zero_counts()
    state = init_state(cfg, dev)
    total = None
    other = not UNPACK_CACHE_DEFAULT
    other_name = "corr_acc_cached" if other else "corr_acc"
    for w, first, last, gulp in gulps_of(dev, cfg, blocks):
        corr_acc(gulp, *state, first, last, w == 0, unpack_cache=other)
        vis = crows.corr_rows(gulp)
        if total is None:
            total = vis
        else:
            for a, b in zip(total, vis):
                a.add_(b)
    torch.cuda.synchronize()
    counts = read_counts()
    want = Vis(*(torch.from_numpy(p).to(dev) for p in slow))
    check(vis_equal(dense_vis(state.vis_slow, cfg), want),
          f"corr_acc(unpack_cache={other}) slow dump over the golden stream")
    check(vis_equal(dense_vis(total, cfg), want),
          "corr_rows summed over the golden stream")
    for name in (other_name, "corr_rows"):
        check(counts[name] > 0, f"{name} not launched")
    print(f"correlator schedules over the golden stream: slow dumps of "
          f"corr_acc(unpack_cache={other}) and of summed corr_rows gulps "
          f"equal the plain slow dump exactly; kernel launches {counts}",
          flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    print(card, flush=True)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    results = {name: {} for name in KERNELS}
    phase_kernels(dev, card, results)
    phase_triu(dev, card, results)
    phase_pfb_direct(dev, card, results)

    rng = np.random.RandomState(0xBF)
    shape = (LWA352.nchan, LWA352.nbeam, LWA352.ninput)
    gains_np = [rng.randint(-8, 9, shape).astype(np.float32)
                for _ in range(2)]
    # path 1, X/B: packed golden input
    blocks = golden_windows(DRIVER_CFG, 3)
    zero_counts()
    window_s = []
    run_geometry(dev, DRIVER_CFG, blocks, gains_np, window_s)
    cfg184 = LWA352.replace(nchan=184, acc_len_slow=2400)
    run_geometry(dev, cfg184, golden_windows(cfg184, 1),
                 [g[:184] for g in gains_np], window_s)
    xb = read_counts()
    for name in (DEFAULT_CORR, "beamform_products", "subsel_gather"):
        check(xb[name] > 0, f"kernel {name} not launched by the X/B path")
    print(f"X/B path kernel launches: {xb}", flush=True)
    # path 2, FX: raw ADC through the channelizer
    fx_window_s = []
    fx, qs = run_fx_path(dev, gains_np, fx_window_s)
    # path 3, F-engine: the channelizer alone at 4096 channels
    fe = run_fengine(dev, card, results)
    # path 4, the operator entry point's threaded driver
    dr, truth, slow, digests, wall = run_driver_path(dev, card, blocks,
                                                     gains_np)
    # path 5, the device mesh: sharded programs and the mesh driver
    me = run_mesh_path(dev, card, blocks, gains_np, qs, truth, slow,
                       digests, wall)
    # the correlator schedules without an engine name
    sc = run_schedules_path(dev, DRIVER_CFG, blocks, slow)
    del blocks, truth, slow
    launches = {name: xb[name] + fx[name] + fe[name] + dr[name] + me[name]
                + sc[name] for name in KERNELS}
    print(f"kernel launches over the five paths and the schedules run: "
          f"{launches}", flush=True)

    cfg = LWA352
    state = init_state(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    packed = torch.randint(0, 256, (cfg.acc_len, cfg.nchan, cfg.ninput),
                           generator=g, device=dev, dtype=torch.uint8)
    gains = bf.BeamGains(*(torch.from_numpy(x).to(dev) for x in gains_np))
    pairs = torch.from_numpy(PAIRS).to(dev)
    step_ms = cuda_ms(lambda: xengine_step(state, packed, gains, pairs, True,
                                           True, False, cfg), 5)
    gbps = cfg.gulp_nbyte * (cfg.acc_len // cfg.ntime_gulp) * 8 / (
        step_ms * 1e-3) / 1e9
    print(f"[{card}] xengine_step, one 2400-spectra window at 704 inputs x "
          f"192 channels: {step_ms:.3f} ms per window ({gbps:.1f} Gb/s of "
          f"packed input; the real-time bar is {cfg.input_gbps:.1f} Gb/s)",
          flush=True)
    tcfg = cfg.replace(**DRIVER_ENGINES["pallas_triu"])
    triu_ms = cuda_ms(lambda: xengine_step(state, packed, gains, pairs, True,
                                           True, False, tcfg), 5)
    print(f"[{card}] xengine_step per window, pallas_triu engines "
          f"(corr_triu.cu + in-place adds): {triu_ms:.3f} ms; default "
          f"engines (corr_acc.cu, {DEFAULT_CORR}): {step_ms:.3f} ms",
          flush=True)
    print(f"[{card}] XEngineRunner host time per window (H2D from pinned "
          f"memory, step, products to numpy): "
          + ", ".join(f"{s:.3f} s" for s in window_s), flush=True)
    del packed
    fcfg = FX_CFG
    L = 2 * fcfg.nchan
    adc = torch.randint(-90, 91, ((fcfg.acc_len + fcfg.pfb_ntap - 1) * L,
                                  fcfg.ninput), generator=g, device=dev,
                        dtype=torch.int8)
    window = torch.from_numpy(pfb.pfb_window(fcfg.nchan,
                                             fcfg.pfb_ntap)).to(dev)
    scale = torch.tensor(qs, device=dev)
    fx_ms = cuda_ms(lambda: fx_step(state, adc, window, scale, gains, pairs,
                                    True, True, False, fcfg), 5)
    msps = fcfg.acc_len * L / (fx_ms * 1e-3) / 1e6
    bar = fcfg.fs_hz / fcfg.npipeline / 1e6
    print(f"[{card}] fx_step (int8 ADC -> pfb_direct -> X/B), one "
          f"2400-spectra window at 704 inputs x 192 channels: {fx_ms:.3f} ms "
          f"per window of {fcfg.acc_len / fcfg.spectra_rate_hz * 1e3:.1f} ms "
          f"of sky; {msps:.2f} Msamples/s per input against the "
          f"{bar:.3f} bar ({msps / bar:.2f}x)", flush=True)
    print(f"[{card}] XEngineRunner FX host time per window (ADC into pinned "
          f"memory, H2D, fx_step, products to numpy): "
          + ", ".join(f"{s:.3f} s" for s in fx_window_s), flush=True)

    kernels = [{"name": name, "route": spec["route"],
                "source": spec["source"], "replaces": spec["replaces"],
                **{k: spec[k] for k in ("also_replaces",) if k in spec},
                "launches": launches[name], **results[name],
                "tolerance": spec["tolerance"]}
               for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
