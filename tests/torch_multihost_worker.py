"""Worker process of ``tests/test_torch_multihost.py`` (the counterpart of
``tests/multihost_worker.py``): joins a 2-process gloo group, forms one
global ('time', 'chan') mesh of 4 CPU shards per process with
``parallel.multihost.global_mesh``, runs the stateful sharded X/B step and
the stateful sharded FX step on the JAX worker's configuration and data,
and writes the products gathered with ``process_allgather``, the arming
start, its channel range and the mesh's traffic to ``out_<pid>.npz``.

Run: python torch_multihost_worker.py <pid> <nproc> <coord_port> <outdir> \
        [placement]

Imports only the port.  The test process imports :func:`run_steps` to run
the same programs on a single-process mesh of the same shape.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from caltech_bifrost_dsp_tpu_torch import config  # noqa: E402
from caltech_bifrost_dsp_tpu_torch.ops import beamform as bf  # noqa: E402
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs  # noqa: E402
from caltech_bifrost_dsp_tpu_torch.ops import pfb  # noqa: E402
from caltech_bifrost_dsp_tpu_torch.parallel import mesh as pm  # noqa: E402
from caltech_bifrost_dsp_tpu_torch.parallel import multihost  # noqa: E402
from caltech_bifrost_dsp_tpu_torch.utils import timeutils  # noqa: E402

CFG = config.XEngineConfig(nstand=8, nchan=32, ntime_gulp=48, acc_len=96,
                           acc_len_slow=192, nbeam=4, ntime_sum=12,
                           nchan_sum=4, npipeline=2)
FXCFG = CFG.replace(pfb_fft_impl="matmul")
LOCAL_SHARDS = 4


def inputs() -> dict:
    """The JAX worker's data: ``RandomState(42)``, identical in every
    process."""
    rng = np.random.RandomState(42)
    packed = rng.randint(0, 256, [CFG.ntime_gulp, CFG.nchan, CFG.ninput]
                         ).astype(np.uint8)
    L = 2 * FXCFG.nchan
    adc = rng.standard_normal(
        [CFG.ntime_gulp * L, FXCFG.ninput]).astype(np.float32) * 3
    return dict(
        packed=packed,
        gains=np.ones((CFG.nchan, CFG.nbeam, CFG.ninput), np.float32),
        pairs=cs.baselines_to_inputs(cs.default_baselines(
            CFG.nvis_out, CFG.nstand)).astype(np.int32),
        adc=adc,
        carry=np.zeros(((FXCFG.pfb_ntap - 1) * L, FXCFG.ninput), np.float32),
        window=pfb.pfb_window(FXCFG.nchan, FXCFG.pfb_ntap).astype(
            np.float32))


def run_steps(mesh) -> dict:
    """The stateful X/B and FX steps (first and last gulp of a window,
    first slow window) on ``mesh``: every product, a ``Sharded``."""
    x = inputs()
    gr = torch.from_numpy(x["gains"])
    gains = bf.BeamGains(gr, torch.zeros_like(gr))
    pairs = torch.from_numpy(x["pairs"])
    step = pm.xengine_sharded_state_fn(CFG, mesh, True, True, True)
    st, out, vlbi = step(pm.zero_sharded_state(CFG, mesh),
                         torch.from_numpy(x["packed"]), gains, pairs)
    got = {"fast_re": out.vis.real, "fast_im": out.vis.imag,
           "sub_re": out.subsel.real, "sub_im": out.subsel.imag,
           "power": out.bf_power, "vlbi": vlbi,
           "slow_re": st[1].real, "slow_im": st[1].imag}
    fxstep = pm.fx_sharded_state_fn(FXCFG, mesh, True, True, True)
    stf, outf, vlbif = fxstep(
        pm.zero_sharded_state(FXCFG, mesh), torch.from_numpy(x["adc"]),
        torch.from_numpy(x["carry"]), torch.from_numpy(x["window"]), 1.0,
        gains, pairs)
    got.update({"fx_re": outf.vis.real, "fx_im": outf.vis.imag,
                "fx_sub_re": outf.subsel.real, "fx_sub_im": outf.subsel.imag,
                "fx_power": outf.bf_power, "fx_vlbi": vlbif,
                "fx_slow_re": stf[1].real})
    return got


def main(argv) -> int:
    pid, nproc, port, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    placement = argv[4] if len(argv) > 4 else "chan"
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
    mesh = multihost.global_mesh(placement=placement,
                                 devices=["cpu"] * LOCAL_SHARDS)
    across = "chan" if placement == "chan" else "time"
    if mesh.shape[across] != nproc or len(mesh.local_coords()) != \
            LOCAL_SHARDS:
        raise SystemExit(f"mesh {mesh.shape}, {len(mesh.local_coords())} "
                         f"local shards")
    lo, hi = multihost.local_channel_range(CFG, mesh)
    sharded = run_steps(mesh)
    try:
        pm.unshard(sharded["power"])
    except ValueError:
        pass
    else:
        raise SystemExit("unshard took blocks of another process")
    got = {k: multihost.process_allgather(v).numpy()
           for k, v in sharded.items()}
    # arming alignment: every process derives the same start from the
    # shared clock arithmetic (the JAX worker's arguments)
    start = timeutils.next_allowed_start(
        now=1_700_000_000.0, delay_s=5.0, sync_time=1_699_999_000.0,
        spectra_rate_hz=CFG.spectra_rate_hz, granularity=CFG.acc_len)
    np.savez(os.path.join(outdir, f"out_{pid}.npz"), **got, start=start,
             chan_range=np.array([lo, hi]), n_time=mesh.n_time,
             n_chan=mesh.n_chan, traffic=json.dumps(mesh.traffic))
    torch.distributed.destroy_process_group()
    print(f"worker {pid} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
