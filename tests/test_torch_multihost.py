"""One mesh across processes in the port (``parallel/multihost.py``).

Two processes (``tests/torch_multihost_worker.py``, 4 CPU shards each)
join a gloo group, form one global ('time', 'chan') mesh and run the
stateful sharded X/B and FX steps on the JAX worker's configuration and
data, with each mesh axis in turn spread over the processes.  Held exactly:
the products gathered in both processes to each other, the fast and FX
visibilities to the JAX single-process references that
``tests/test_multihost.py`` uses, and every product to the port's
single-process mesh of the same shape; the arming start and the channel
ranges as in the JAX test; and which collectives crossed processes.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_multihost_worker as worker
from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.ops import beamform as jbf
from caltech_bifrost_dsp_tpu.parallel import mesh as jmesh
from caltech_bifrost_dsp_tpu.verification import golden
from caltech_bifrost_dsp_tpu_torch.config import LWA352
from caltech_bifrost_dsp_tpu_torch.parallel import mesh as pm
from caltech_bifrost_dsp_tpu_torch.parallel import multihost

REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 240


def free_port() -> int:
    """A TCP port the system reports free (the JAX test holds fixed
    ones)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k not in multihost.ENV_VARS}
    env["PYTHONPATH"] = str(REPO)
    return env


def run_pair(argvs) -> list:
    """Two processes at once; each must exit 0 within the time limit."""
    procs = [subprocess.Popen(argv, env=port_env(), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out}"
    return outs


@pytest.mark.parametrize("placement", ["chan", "time"])
def test_two_process_global_mesh(tmp_path, placement):
    port = free_port()
    run_pair([[sys.executable, str(REPO / "tests/torch_multihost_worker.py"),
               str(pid), "2", str(port), str(tmp_path), placement]
              for pid in range(2)])
    a = np.load(tmp_path / "out_0.npz")
    b = np.load(tmp_path / "out_1.npz")
    keys = [k for k in a.files if k not in ("traffic", "chan_range")]
    for key in keys:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    # FX visibilities Hermitian with non-negative autos
    fx = a["fx_re"] + 1j * a["fx_im"]
    np.testing.assert_array_equal(fx, np.conj(np.swapaxes(fx, 1, 2)))
    assert (np.real(np.diagonal(fx, axis1=1, axis2=2)) >= 0).all()
    # the same arming start in both processes
    assert a["start"] == b["start"] and int(a["start"]) % 96 == 0
    ranges = sorted([tuple(a["chan_range"]), tuple(b["chan_range"])])
    if placement == "chan":
        # disjoint channel ranges that abut and cover the band
        assert ranges[0][1] == ranges[1][0]
        assert ranges[0][0] == 0 and ranges[1][1] == 32
    else:
        assert ranges == [(0, 32), (0, 32)]

    # the JAX single-process references
    x = worker.inputs()
    ref = golden.reference_correlation(x["packed"].reshape(48, 32, 8, 2))
    ref = ref.transpose(0, 1, 3, 2, 4).reshape(32, 16, 16)
    np.testing.assert_array_equal(a["fast_re"], ref.real.astype(np.int64))
    np.testing.assert_array_equal(a["fast_im"], ref.imag.astype(np.int64))
    jcfg = C.XEngineConfig(nstand=8, nchan=32, ntime_gulp=48, acc_len=96,
                           acc_len_slow=192, nbeam=4, ntime_sum=12,
                           nchan_sum=4, npipeline=2, pfb_fft_impl="matmul")
    gains = jbf.BeamGains(jnp.asarray(x["gains"]),
                          jnp.zeros_like(jnp.asarray(x["gains"])))
    fxref = jmesh.fx_reference_unsharded(
        jcfg, jnp.asarray(x["adc"]), jnp.asarray(x["window"]), gains,
        jnp.asarray(x["pairs"]), jnp.float32(1.0),
        n_time_shards=int(a["n_time"]))
    np.testing.assert_array_equal(a["fx_re"], np.asarray(fxref.vis.real))
    np.testing.assert_array_equal(a["fx_im"], np.asarray(fxref.vis.imag))

    # the port's single-process mesh of the same shape, product by product
    n_time, n_chan = int(a["n_time"]), int(a["n_chan"])
    torch.set_num_threads(1)
    one = worker.run_steps(pm.make_mesh(n_time, n_chan,
                                        devices=["cpu"] * (n_time * n_chan)))
    for key, sx in one.items():
        np.testing.assert_array_equal(a[key], pm.unshard(sx).numpy(),
                                      err_msg=key)

    # what crossed processes: the spread axis's collectives only
    sent = {}
    for f in (a, b):
        for name, tally in json.loads(str(f["traffic"])).items():
            sent[name] = sent.get(name, 0) + tally["sent_bytes"]
    crossing = {"chan": {"all_to_all", "all_gather"},
                "time": {"psum", "ppermute_halo"}}[placement]
    assert {k for k, v in sent.items() if v} == crossing, sent


def test_initialize_one_process_is_a_no_op():
    multihost.initialize("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


def test_initialize_without_rendezvous_warns(monkeypatch):
    for k in multihost.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    with pytest.warns(UserWarning, match="single-process"):
        multihost.initialize()
    assert not dist.is_initialized()
    mesh = multihost.global_mesh(placement="time", devices=["cpu"] * 2)
    assert mesh.shape == {"time": 1, "chan": 2} and mesh.nproc == 1
    assert multihost.local_channel_range(LWA352, mesh) == (0, 192)


ENV_RENDEZVOUS = textwrap.dedent("""
    import torch, torch.distributed as dist
    from caltech_bifrost_dsp_tpu_torch.config import LWA352
    from caltech_bifrost_dsp_tpu_torch.parallel import multihost
    multihost.initialize()
    x = torch.tensor([dist.get_rank() + 1])
    dist.all_reduce(x)
    mesh = multihost.global_mesh(devices=["cpu"])
    print(dist.get_world_size(), int(x), mesh.shape["chan"],
          multihost.local_channel_range(LWA352, mesh))
    dist.destroy_process_group()
""")


def test_initialize_env_rendezvous_in_two_processes():
    port = free_port()
    argvs = []
    for rank in range(2):
        argvs.append(["env", "MASTER_ADDR=127.0.0.1", f"MASTER_PORT={port}",
                      "WORLD_SIZE=2", f"RANK={rank}", sys.executable, "-c",
                      ENV_RENDEZVOUS])
    outs = run_pair(argvs)
    lines = sorted(o.strip().splitlines()[-1] for o in outs)
    assert lines == ["2 3 2 (0, 96)", "2 3 2 (96, 192)"], outs


def test_unknown_placement_and_backend_raise():
    with pytest.raises(ValueError, match="placement"):
        multihost.global_mesh(placement="stand", devices=["cpu"])
    with pytest.raises(ValueError, match="placement"):
        multihost.split_volumes(LWA352, 2, 2, "stand")
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("127.0.0.1:1", 2, 0, backend="mpi")


def test_nccl_refuses_two_ranks_on_one_device():
    with pytest.raises(ValueError, match="two ranks on one device"):
        multihost._check_backend("nccl", [["cuda:0"], ["cuda:0"]])
    with pytest.raises(NotImplementedError, match="gloo"):
        multihost._check_backend("nccl", [["cuda:0"], ["cuda:1"]])
    multihost._check_backend("gloo", [["cuda:0"] * 2, ["cuda:0"] * 2])


@pytest.mark.parametrize("placement", ["chan", "time"])
def test_split_volumes_by_placement(placement):
    """Each collective's bytes split whole: the spread axis's collectives
    cross processes, the other axis's stay; the totals are
    ``collective_volumes``'s."""
    vols = multihost.split_volumes(LWA352, 2, 2, placement)
    want = pm.collective_volumes(LWA352, 2, 2)
    for v, w in zip(vols["collectives"], want["collectives"]):
        assert v["total_bytes_per_window"] == w["total_bytes_per_window"]
        crossing = v["mesh_axis"] == placement
        assert v["cross_process_bytes_per_window"] == (
            v["total_bytes_per_window"] if crossing else 0)
        assert v["in_process_bytes_per_window"] == (
            0 if crossing else v["total_bytes_per_window"])
