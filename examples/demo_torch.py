"""End-to-end demo of the X-engine library API, PyTorch + CUDA port.

The port's counterpart of ``examples/demo.py``: a miniature observation at
``config.TINY`` with golden-vector input, the fused correlate + beamform
pipeline under runtime control, product packetization and a triggered
voltage dump, then the correlation products checked exactly against the
golden file.

    python examples/demo_torch.py              # on the card
    python examples/demo_torch.py --device cpu # the kernels' plain versions

Exits 0 when every slow dump equals the golden file, 1 otherwise, and 2
for ``--device cuda`` on a host without a card.
"""

import argparse
import os
import socket
import sys
import tempfile

import numpy as np

# runnable as `python examples/demo_torch.py` from anywhere (the package is
# not pip-installed; sys.path[0] is examples/, not the repo root)
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import torch  # noqa: E402

from caltech_bifrost_dsp_tpu_torch.config import TINY  # noqa: E402
from caltech_bifrost_dsp_tpu_torch.control.client import (  # noqa: E402
    CorrControlClient, PipelineControl)
from caltech_bifrost_dsp_tpu_torch.control.command import (  # noqa: E402
    CommandBlock)
from caltech_bifrost_dsp_tpu_torch.control.monitor import (  # noqa: E402
    MonitorBridge, render_text)
from caltech_bifrost_dsp_tpu_torch.control.store import (  # noqa: E402
    MemoryStore)
from caltech_bifrost_dsp_tpu_torch.io import packets as pk  # noqa: E402
from caltech_bifrost_dsp_tpu_torch.io import sink, source  # noqa: E402
from caltech_bifrost_dsp_tpu_torch.runtime.driver import (  # noqa: E402
    XEnginePipeline)
from caltech_bifrost_dsp_tpu_torch.verification import golden  # noqa: E402


def run(device: str, tmp: str) -> dict:
    """The six steps, files under ``tmp``; returns the counts the summary
    prints."""
    cfg = TINY
    ntime = 2 * cfg.acc_len_slow

    print("1. generating golden vectors ...")
    in_path = os.path.join(tmp, "in.dat")
    corr_path = os.path.join(tmp, "corr.dat")
    golden.write_input_file(in_path, ntime, cfg.nchan, cfg.nstand,
                            cfg.npol, cfg.acc_len)
    golden.write_corr_file(corr_path, ntime, cfg.nchan, cfg.nstand,
                           cfg.npol, cfg.acc_len)

    print(f"2. building the pipeline on {device} ...")
    CommandBlock.reset_instance_counts()
    store = MemoryStore()
    src = source.SyntheticSource(cfg, mode="testfile", testfile=in_path)
    cor_pkts, pbeam_pkts = [], []
    corr_out = sink.CorrFullOutput(cfg, send=cor_pkts.append,
                                   checkfile=corr_path,
                                   checkfile_acc_len=cfg.acc_len)
    pb_out = sink.PBeamOutput(cfg, senders={0: pbeam_pkts.append})
    pipe = XEnginePipeline(cfg, src, store=store,
                           corr_outputs=[corr_out],
                           pbeam_outputs=[pb_out],
                           history_nbyte=16 * cfg.gulp_nbyte, device=device)

    print("3. loading beam coefficients over the control plane ...")
    cli = CorrControlClient(store=store)
    ctl = PipelineControl(cli, socket.gethostname(), 0)
    for b in range(cfg.nbeam):
        ctl.beamform.update_delays(b, np.zeros(cfg.ninput), load_sample=-1)

    print("4. running ...")
    pipe.run(ntime // cfg.ntime_gulp, timeout_s=600)

    print("5. triggering a voltage dump ...")
    files = pipe.dumper.trigger(ntime_per_file=cfg.ntime_gulp, nfile=1,
                                dump_path=tmp)
    replay = source.TriggerFileSource(files[0])
    hdr, _ = replay.read()

    print("6. results:")
    print(f"   fast dumps: {pipe.ndump_fast}, slow dumps:"
          f" {pipe.ndump_slow}")
    print(f"   golden checks passed: "
          f"{corr_out.check_count - corr_out.check_failures}"
          f"/{corr_out.check_count}")
    print(f"   COR packets: {len(cor_pkts)}, PBEAM packets:"
          f" {len(pbeam_pkts)}")
    h, _ = pk.decode_corr_full(cor_pkts[0])
    print(f"   first COR packet: stands ({h.stand0},{h.stand1}), "
          f"acc_len {h.acc_len}")
    print(f"   dump file: {os.path.basename(files[0])} "
          f"({hdr['ntime']} samples from spectra {hdr['seq0']})")
    MonitorBridge(store).publish_once()
    print("   monitor:")
    for line in render_text(store).splitlines()[:4]:
        print("    ", line)
    return {"ndump_fast": pipe.ndump_fast, "ndump_slow": pipe.ndump_slow,
            "checks": corr_out.check_count,
            "check_failures": corr_out.check_failures,
            "cor_packets": len(cor_pkts), "pbeam_packets": len(pbeam_pkts),
            "dump_ntime": hdr["ntime"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the kernels; cpu their plain versions")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available (use "
              "--device cpu)", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="cbd-demo-") as tmp:
        out = run(args.device, tmp)
    if out["check_failures"] or not out["checks"]:
        print("demo FAILED: slow dumps differ from the golden file")
        return 1
    print("demo OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
