"""Device bench of the fused X/B step on one GPU, the port's counterpart of
the JAX package's root ``bench.py``.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.bench_step [--windows N]

Times :func:`..models.xengine.xengine_step` at ``config.LWA352`` with
``config.TPU_ENGINES``, one call per 2400-spectra fast window (~100.3 ms of
sky): correlate into the fast accumulator, slow accumulate, subselect the
production baselines, 32 beams with power integration and VLBI.  The calls
are chained through the carried state (each updates it in place) and timed
with CUDA events over ``--windows`` calls after one warm-up call.  The
window is random packed bytes drawn on the card from a seed, in the
capture-ring order [ntime, nchan, ninput]; gains are unity and the
selection is ``production_baselines`` (``xengine.default_inputs``).

Throughput is the packed 4+4-bit input rate in Gb/s; ``vs_baseline`` is
that rate over the reference's real-time bar of 25.9 Gb/s per pipeline
(BASELINE.md; 1.0 is real time).

Prints one JSON line with the JAX bench's keys (``metric``, ``value``,
``unit``, ``vs_baseline``), ``ms_per_window``, ``windows`` and the card's
``device`` and ``power_limit``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..config import LWA352, TPU_ENGINES
from ..models import xengine
from ..utils.roofline import card_fields, cuda_ms

#: the reference's real-time requirement, Gb/s of packed input (BASELINE.md)
BASELINE_GBPS = 25.9


def measure(windows: int, dev, seed: int = 1) -> dict:
    """ms per fast window of the chained step and the JSON row."""
    cfg = LWA352.replace(**TPU_ENGINES)
    state, _, gains, pairs = xengine.default_inputs(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (cfg.acc_len, cfg.nchan, cfg.ninput),
                           generator=g, device=dev, dtype=torch.uint8)

    def window():
        xengine.xengine_step(state, packed, gains, pairs, True, True, False,
                             cfg)

    ms = cuda_ms(window, windows)
    gbps = 8 * cfg.acc_len * cfg.nchan * cfg.ninput / (ms * 1e-3) / 1e9
    return {"metric": "xengine_sustained_input_rate", "value": gbps,
            "unit": "Gb/s", "vs_baseline": gbps / BASELINE_GBPS,
            "ms_per_window": ms, "windows": windows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="X/B step bench on one GPU")
    p.add_argument("--windows", type=int, default=20,
                   help="timed fast windows after one warm-up window")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_step: no CUDA device", file=sys.stderr)
        return 1
    row = measure(args.windows, torch.device("cuda:0"))
    row.update(card_fields())
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
