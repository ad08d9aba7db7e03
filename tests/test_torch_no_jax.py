"""The port, its CLI, the operator scripts, the offline, receiver and
golden CLIs, the benches and ``utils/roofline.py``, the soak and its
loopback processes, the multi-process mesh and its test worker, the demo
``examples/demo_torch.py`` and ``chip_smoke.py`` import without JAX and
without any module of the JAX package (and without ``grpc``, which only an
etcd store needs; the offline CLIs replay without ``h5py``, which only
their writers need), an ``XEnginePipeline`` runs on the CPU (unsharded and
on a 2x2 mesh, and with the stub device) in such a process, the port's
native loader builds and
loads its own library and leaves the JAX package's
``native/libcbd_native.so`` as it was, and the CLI and the bench refuse to
run on a host without a card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import sys
import caltech_bifrost_dsp_tpu_torch.config
import caltech_bifrost_dsp_tpu_torch.control.client
import caltech_bifrost_dsp_tpu_torch.control.command
import caltech_bifrost_dsp_tpu_torch.control.etcd3_wire
import caltech_bifrost_dsp_tpu_torch.control.manager
import caltech_bifrost_dsp_tpu_torch.control.monitor
import caltech_bifrost_dsp_tpu_torch.control.netstore
import caltech_bifrost_dsp_tpu_torch.control.store
import caltech_bifrost_dsp_tpu_torch.io.hdf5
import caltech_bifrost_dsp_tpu_torch.io.native
import caltech_bifrost_dsp_tpu_torch.io.packets
import caltech_bifrost_dsp_tpu_torch.io.sink
import caltech_bifrost_dsp_tpu_torch.io.source
import caltech_bifrost_dsp_tpu_torch.models.offline
import caltech_bifrost_dsp_tpu_torch.models.xengine
import caltech_bifrost_dsp_tpu_torch.ops.corr_blk
import caltech_bifrost_dsp_tpu_torch.ops.corr_rows
import caltech_bifrost_dsp_tpu_torch.ops.corr_triu
import caltech_bifrost_dsp_tpu_torch.ops.pfb
import caltech_bifrost_dsp_tpu_torch.ops.pfb_fused
import caltech_bifrost_dsp_tpu_torch.ops.xgpu_order
import caltech_bifrost_dsp_tpu_torch.parallel.mesh
import caltech_bifrost_dsp_tpu_torch.parallel.multihost
import caltech_bifrost_dsp_tpu_torch.runtime.arming
import caltech_bifrost_dsp_tpu_torch.runtime.driver
import caltech_bifrost_dsp_tpu_torch.runtime.ring
import caltech_bifrost_dsp_tpu_torch.scripts.arm_correlator
import caltech_bifrost_dsp_tpu_torch.scripts.beam_rx
import caltech_bifrost_dsp_tpu_torch.scripts.bench_fx
import caltech_bifrost_dsp_tpu_torch.scripts.bench_ingest
import caltech_bifrost_dsp_tpu_torch.scripts.bench_pipeline
import caltech_bifrost_dsp_tpu_torch.scripts.bench_scaling
import caltech_bifrost_dsp_tpu_torch.scripts.bench_stages
import caltech_bifrost_dsp_tpu_torch.scripts.bench_step
import caltech_bifrost_dsp_tpu_torch.scripts.check_golden
import caltech_bifrost_dsp_tpu_torch.scripts.corr_part_rx
import caltech_bifrost_dsp_tpu_torch.scripts.corr_rx
import caltech_bifrost_dsp_tpu_torch.scripts.gpu_parity
import caltech_bifrost_dsp_tpu_torch.scripts.make_golden
import caltech_bifrost_dsp_tpu_torch.scripts.monitor
import caltech_bifrost_dsp_tpu_torch.scripts.pipeline
import caltech_bifrost_dsp_tpu_torch.scripts.probe_rx
import caltech_bifrost_dsp_tpu_torch.scripts.snap_rx
import caltech_bifrost_dsp_tpu_torch.scripts.soak
import caltech_bifrost_dsp_tpu_torch.scripts.soak_wire
import caltech_bifrost_dsp_tpu_torch.scripts.upchan_bf
import caltech_bifrost_dsp_tpu_torch.scripts.upchan_imag
import caltech_bifrost_dsp_tpu_torch.scripts.xeng_manager
import caltech_bifrost_dsp_tpu_torch.utils.proclog
import caltech_bifrost_dsp_tpu_torch.utils.roofline
import caltech_bifrost_dsp_tpu_torch.utils.skycoords
import caltech_bifrost_dsp_tpu_torch.utils.timeutils
import chip_smoke
sys.path.insert(0, "tests")
import torch_multihost_worker
sys.path.insert(0, "examples")
import demo_torch
from caltech_bifrost_dsp_tpu_torch.config import TINY
from caltech_bifrost_dsp_tpu_torch.io.sink import CorrPartOutput
from caltech_bifrost_dsp_tpu_torch.io.source import SyntheticSource
from caltech_bifrost_dsp_tpu_torch.parallel.mesh import make_mesh
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
cfg = TINY.replace(corr_engine="pallas_triu", subsel_engine="pallas")
pkts = []
pipe = XEnginePipeline(cfg, SyntheticSource(cfg, mode="random"),
                       subsel_outputs=[CorrPartOutput(cfg, send=pkts.append)],
                       device="cpu")
pipe.run(20, timeout_s=60)
assert pipe.ndump_fast == 4 and pipe.ndump_slow == 2 and pkts
mpkts = []
mpipe = XEnginePipeline(cfg, SyntheticSource(cfg, mode="random"),
                        subsel_outputs=[CorrPartOutput(cfg,
                                                       send=mpkts.append)],
                        device="cpu",
                        mesh=make_mesh(2, 2, devices=["cpu"] * 4))
mpipe.run(20, timeout_s=60)
assert mpkts == pkts
spipe = XEnginePipeline(cfg, SyntheticSource(cfg, skip_write=True),
                        subsel_outputs=[CorrPartOutput(cfg, send=[].append)],
                        device="cpu", stub_device_ms=0.1)
spipe.run(20, timeout_s=60)
assert spipe.ndump_fast == 4 and spipe.state is None
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "jaxlib")
assert not bad, bad
ref = sorted(m for m in sys.modules if m == "caltech_bifrost_dsp_tpu"
             or m.startswith("caltech_bifrost_dsp_tpu."))
assert not ref, ref
print("no jax")
"""


def _run(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


WITHOUT_GRPC = """
import sys
sys.modules["grpc"] = None  # as on a host without grpcio
MODULES = [
    "caltech_bifrost_dsp_tpu_torch.control.client",
    "caltech_bifrost_dsp_tpu_torch.control.command",
    "caltech_bifrost_dsp_tpu_torch.control.etcd3_wire",
    "caltech_bifrost_dsp_tpu_torch.control.manager",
    "caltech_bifrost_dsp_tpu_torch.control.monitor",
    "caltech_bifrost_dsp_tpu_torch.control.netstore",
    "caltech_bifrost_dsp_tpu_torch.control.store",
    "caltech_bifrost_dsp_tpu_torch.io.sink",
    "caltech_bifrost_dsp_tpu_torch.io.source",
    "caltech_bifrost_dsp_tpu_torch.runtime.driver",
    "caltech_bifrost_dsp_tpu_torch.scripts.arm_correlator",
    "caltech_bifrost_dsp_tpu_torch.scripts.monitor",
    "caltech_bifrost_dsp_tpu_torch.scripts.pipeline",
    "caltech_bifrost_dsp_tpu_torch.scripts.xeng_manager",
    "caltech_bifrost_dsp_tpu_torch.utils.timeutils",
    "chip_smoke",
]
import importlib
for m in MODULES:
    importlib.import_module(m)
from caltech_bifrost_dsp_tpu_torch.control.netstore import NetStore, StoreServer
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore, connect
assert isinstance(connect(None), MemoryStore)
srv = StoreServer(port=0)
st = connect(f"kv://127.0.0.1:{srv.port}")
assert isinstance(st, NetStore)
st.put("/k", "v")
assert st.get("/k") == "v"
st.close()
srv.close()
try:
    connect("somehost")
except ImportError as e:
    assert "grpc" in str(e), e
else:
    raise AssertionError("connect('somehost') did not raise ImportError")
assert sys.modules["grpc"] is None
print("no grpc")
"""


def test_port_imports_and_connects_without_grpc():
    """Every module of the port imports where ``grpc`` is missing, the
    in-process and ``kv://`` stores work, and an etcd host raises
    ``ImportError`` naming grpc, with nothing put in its place."""
    proc = _run(["-c", WITHOUT_GRPC])
    assert proc.returncode == 0, proc.stderr
    assert "no grpc" in proc.stdout


def test_port_imports_without_jax():
    proc = _run(["-c", IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout


WITHOUT_H5PY = """
import sys
sys.modules["h5py"] = None  # as on a host without h5py
import numpy as np
from caltech_bifrost_dsp_tpu_torch.config import TINY
from caltech_bifrost_dsp_tpu_torch.io import sink, source
from caltech_bifrost_dsp_tpu_torch.runtime.ring import HistoryRing
from caltech_bifrost_dsp_tpu_torch.scripts import upchan_bf, upchan_imag
frame = TINY.nchan * TINY.ninput
ring = HistoryRing(nbyte=96 * frame, frame_nbyte=frame)
ring.set_header(source.sequence_header(TINY, seq0=0), frame0_seq=0)
for i in range(96):
    ring.push(np.full(frame, i, np.uint8))
path = sink.TriggeredDump(ring, dump_path=sys.argv[1]).trigger(96)[0]
for cli, argv in ((upchan_bf, ["--nupchan", "8", "--gulp", "48"]),
                  (upchan_imag, ["--end-freq", "32", "--gulp", "48"])):
    args = cli.build_parser().parse_args(
        ["--datain", path, "--device", "cpu"] + argv)
    replay = cli.Replay(args)
    try:
        cli.write(args, replay)
    except ImportError as e:
        assert "h5py" in str(e), e
    else:
        raise AssertionError("wrote HDF5 without h5py")
print("no h5py")
"""


def test_offline_clis_replay_without_h5py(tmp_path):
    """The offline CLIs' replay runs where ``h5py`` is missing (as on the
    card's host); only their writers need it, and they say so."""
    proc = _run(["-c", WITHOUT_H5PY, str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    assert "no h5py" in proc.stdout


LOAD_NATIVE = """
import os, sys
from pathlib import Path
jax_lib = Path("native/libcbd_native.so")
def state():
    return jax_lib.stat().st_mtime_ns if jax_lib.exists() else None
before = state()
from caltech_bifrost_dsp_tpu_torch.io import native
lib = native.load()
assert Path(lib._name).parent == native.BUILD_DIR, lib._name
assert state() == before, (before, state())
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("caltech_bifrost_dsp_tpu."))
assert not bad, bad
print("own library")
"""


def test_native_loader_leaves_the_jax_library_alone():
    proc = _run(["-c", LOAD_NATIVE])
    assert proc.returncode == 0, proc.stderr
    assert "own library" in proc.stdout


def test_cli_device_cuda_fails_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["-m", "caltech_bifrost_dsp_tpu_torch.scripts.pipeline",
                 "--fakesource", "--ngulp", "1", "--device", "cuda"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_bench_fx_fails_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["-m", "caltech_bifrost_dsp_tpu_torch.scripts.bench_fx",
                 "--fengine", "--nspec", "1"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
