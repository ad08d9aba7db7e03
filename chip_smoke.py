"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from ``caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc``,
holds each against its plain PyTorch version at the LWA-352 production
shapes (704 inputs, 192 channels, 2400-spectra window, 32 beams), then
drives the port's main path -- :class:`XEngineRunner` over the golden input
stream (seed 0xdeadbeef) -- for three fast windows at 192 channels and one
at 184, checking every product against the plain versions on the card and
the host truth.  It times each kernel beside its plain version and the
full step per window.  The last line is ``{"ok": true, "device": ...}``;
any failure raises and exits non-zero.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from caltech_bifrost_dsp_tpu.config import LWA352
from caltech_bifrost_dsp_tpu_torch.models.xengine import (dense_vis,
                                                          init_state,
                                                          xengine_step)
from caltech_bifrost_dsp_tpu_torch.ops import beamform as bf
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs
from caltech_bifrost_dsp_tpu_torch.ops.corr_acc import corr_acc, corr_acc_ref
from caltech_bifrost_dsp_tpu_torch.ops.correlate import (Vis, chan_major,
                                                         correlate_chan_major)
from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build
from caltech_bifrost_dsp_tpu_torch.runtime.runner import XEngineRunner
from caltech_bifrost_dsp_tpu_torch.verification import golden

SEED = 0xdeadbeef
KERNELS = {
    "corr_acc": dict(
        fn=corr_acc, route="cuda",
        source="caltech_bifrost_dsp_tpu_torch/ops/kernels/csrc/corr_acc.cu",
        replaces="caltech_bifrost_dsp_tpu/ops/pallas/corr_blk.py:123",
        tolerance="exact int32 on j >= i"),
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
        tolerance="exact int32"),
}
# the production selection plus one malformed pair (stand 400 of 352)
PAIRS = np.concatenate([
    cs.baselines_to_inputs(cs.production_baselines(LWA352.nvis_out,
                                                   LWA352.nstand)),
    cs.baselines_to_inputs([[[400, 0], [3, 1]]])]).astype(np.int32)


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
        corr_acc(packed, Vis(*got[:2]), Vis(*got[2:]), *flags)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            check(torch.equal(a[:, upper], b[:, upper]),
                  f"corr_acc != plain on j >= i, flags {flags}")
            err = max(err, max_abs(a[:, upper], b[:, upper]))
        print(f"corr_acc flags {flags}: exact int32 on j >= i", flush=True)
    del want
    state = rand_planes()
    fast, slow = Vis(*state[:2]), Vis(*state[2:])
    ms = cuda_ms(lambda: corr_acc(packed, fast, slow, False, True, False),
                 5)
    plain_ms = cuda_ms(lambda: corr_acc_ref(xc, fast, slow, False, True,
                                            False), 2)
    results["corr_acc"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    pairs = torch.from_numpy(PAIRS).to(dev)
    got = cs.corr_subsel(fast, pairs, cfg.nchan_sum)
    want = cs.corr_subsel_ref(fast, pairs, cfg.nchan_sum)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        check(torch.equal(a, b), "subsel != plain")
    print("subsel_gather: exact int32, malformed pair included", flush=True)
    results["subsel_gather"].update(
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
        max_abs_err=err,
        ms=cuda_ms(lambda: bf.beamform_products(packed, gains,
                                                cfg.ntime_sum), 10),
        plain_ms=cuda_ms(lambda: bf.beamform_products_ref(
            xc, gains, cfg.ntime_sum), 3))
    for name, r in results.items():
        print(f"[{card}] {name}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms per call at the production shape",
              flush=True)


def run_geometry(dev, cfg, nwin: int, gains_np, window_s: list) -> None:
    """Drive XEngineRunner over ``nwin`` golden windows; hold every product
    against the plain versions on the card (anchored to the host truth on
    4 channels per window)."""
    ni = cfg.ninput
    blocks = list(golden.generate_input_blocks(
        nwin * cfg.acc_len, cfg.nchan, cfg.nstand, cfg.npol, cfg.acc_len))
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

    rng = np.random.RandomState(0xBF)
    shape = (LWA352.nchan, LWA352.nbeam, LWA352.ninput)
    gains_np = [rng.randint(-8, 9, shape).astype(np.float32)
                for _ in range(2)]
    for spec in KERNELS.values():
        spec["fn"].launches = 0
    window_s = []
    run_geometry(dev, LWA352.replace(acc_len_slow=7200), 3, gains_np,
                 window_s)
    run_geometry(dev, LWA352.replace(nchan=184, acc_len_slow=2400), 1,
                 [g[:184] for g in gains_np], window_s)
    launches = {name: spec["fn"].launches for name, spec in KERNELS.items()}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} not launched by the main path")
    print(f"main-path kernel launches: {launches}", flush=True)

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
    print(f"[{card}] XEngineRunner host time per window (H2D from pinned "
          f"memory, step, products to numpy): "
          + ", ".join(f"{s:.3f} s" for s in window_s), flush=True)

    kernels = [{"name": name, "route": spec["route"],
                "source": spec["source"], "replaces": spec["replaces"],
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
