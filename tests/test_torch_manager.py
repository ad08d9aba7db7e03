"""The port's host manager (``control/manager.py``, ``scripts/
xeng_manager.py``) and the whole control plane across processes: the
cases of ``tests/test_manager.py`` and ``tests/test_multiprocess_system.py``
with the port's CLI as the pipeline (``--device cpu`` at the shapes of
those tests), commanded over the bundled TCP store, its transient recorder
triggered through the client.  Every wait is bounded."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu.control import client as jclient
from caltech_bifrost_dsp_tpu.control import manager as jmanager
from caltech_bifrost_dsp_tpu_torch.control.client import (CorrControlClient,
                                                          CorrelatorControl,
                                                          PipelineControl)
from caltech_bifrost_dsp_tpu_torch.control.manager import (
    XengineController, XengineManagerService)
from caltech_bifrost_dsp_tpu_torch.control.netstore import (NetStore,
                                                            StoreServer)
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore
from caltech_bifrost_dsp_tpu_torch.io.source import TriggerFileSource

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--fakesource", "--device", "cpu", "--nchan", "16", "--nstand",
         "16", "--nbeam", "4", "--ntime_gulp", "48", "--acc_len", "240",
         "--acc_len_slow", "480", "--ngulp", "0"]


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(REPO)
    e["OMP_NUM_THREADS"] = "1"
    return e


def sleeper(tmp_path):
    """A controller whose "pipeline" sleeps until it is stopped."""
    return XengineController(
        pidfile_dir=str(tmp_path),
        pipeline_cmd=[sys.executable, "-c",
                      "import time,sys; time.sleep(60)", "--ignore"])


def wait_for(pred, timeout_s, poll_s=0.1):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            v = pred()
        except (OSError, ValueError, KeyError):
            v = None
        if v:
            return v
        time.sleep(poll_s)
    return None


def test_default_command_is_the_port_cli():
    cmd = XengineController().pipeline_cmd
    assert cmd[1:] == ["-m", "caltech_bifrost_dsp_tpu_torch.scripts.pipeline"]
    assert jmanager.XengineController().pipeline_cmd[-1] == \
        "caltech_bifrost_dsp_tpu.scripts.pipeline"


def test_start_stop_pipeline(tmp_path):
    ctl = sleeper(tmp_path)
    assert ctl.start_pipeline(0)["ok"]
    assert ctl.pipeline_is_up(0)
    assert not ctl.start_pipeline(0)["ok"]  # already running
    t0 = time.monotonic()
    rv = ctl.stop_pipeline(0)
    assert rv["ok"] and rv["returncode"] == -signal.SIGTERM
    assert time.monotonic() - t0 < 5.0  # reaped, not waited out
    assert not ctl.pipeline_is_up(0)
    assert not ctl.stop_pipeline(0)["ok"]
    assert not (tmp_path / "cbd-tpu-pipeline-0.pid").exists()


def test_kill_pipelines(tmp_path):
    ctl = sleeper(tmp_path)
    ctl.start_pipeline(1)
    ctl.start_pipeline(2)
    assert ctl.status()["pipelines"] == {1: True, 2: True}
    ctl.kill_pipelines()
    assert not ctl.pipeline_is_up(1)
    assert not ctl.pipeline_is_up(2)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_rpc_dispatch_and_underscore_guard(tmp_path, client):
    """Commands by method name; private and unknown names are errors.  The
    JAX package's manager RPC envelope drives the port's service."""
    store = MemoryStore()
    ctl = sleeper(tmp_path)
    svc = XengineManagerService(store, ctl)
    if client == "jax":
        jsvc = jmanager.XengineManagerService(MemoryStore(), ctl)
        assert (jsvc.cmd_key, jsvc.resp_key) == (svc.cmd_key, svc.resp_key)
        jsvc.close()

    def rpc(cmd, **kwargs):
        store.put(svc.cmd_key, json.dumps(
            {"cmd": cmd, "id": "7", "val": {"kwargs": kwargs}}))
        return json.loads(store.get(svc.resp_key))["val"]

    assert rpc("status")["status"] == "normal"
    r = rpc("start_pipeline", pipeline_id=3)
    assert r["status"] == "normal" and ctl.pipeline_is_up(3)
    assert rpc("stop_pipeline", pipeline_id=3)["status"] == "normal"
    assert rpc("_pid_alive", pid=1)["status"] == "error"
    assert rpc("no_such_method")["status"] == "error"
    store.put(svc.cmd_key, "not json")
    assert json.loads(store.get(svc.resp_key))["val"]["status"] == "error"
    svc.close()
    ctl.kill_pipelines()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def manager_rpc(store, host, cmd, seq, wait_s=30.0, **kwargs):
    """One RPC to the manager of ``host``; the response's ``val``."""
    key = f"/cmd/corr/x/{host}/xctrl"
    resp_key = f"/resp/corr/x/{host}/xctrl"
    store.put(key, json.dumps({"cmd": cmd, "id": seq,
                               "val": {"kwargs": kwargs}}))

    def answered():
        raw = store.get(resp_key)
        v = json.loads(raw) if raw else {}
        return v.get("val") if v.get("id") == seq else None

    val = wait_for(answered, wait_s, 0.05)
    assert val is not None, f"no answer to {cmd}"
    return val


def test_manager_script_runs_a_recording_port_pipeline(tmp_path):
    """``xeng_manager --serve-kv`` in a process of its own starts the
    port's CLI with ``--etcdhost kv://`` ``--bufgbytes`` ``--dump-direct``;
    the pipeline answers an ``acc_len`` command, dumps its history ring on
    a trigger (the file replays to the ramp it was fed) and exits 0 when
    stopped."""
    port = free_port()
    kv = f"kv://127.0.0.1:{port}"
    log = open(tmp_path / "manager.log", "wb")
    mgr = subprocess.Popen(
        [sys.executable, "-m",
         "caltech_bifrost_dsp_tpu_torch.scripts.xeng_manager",
         "--serve-kv", str(port), "--pidfile-dir", str(tmp_path)],
        cwd=REPO, env=env(), stdout=log, stderr=subprocess.STDOUT)
    store = None
    try:
        store = wait_for(lambda: NetStore(port=port), 60)
        assert store is not None, "manager's store never came up"
        host = socket.gethostname()
        r = manager_rpc(store, host, "start_pipeline", "s", pipeline_id=0,
                        extra_args=SMALL + ["--etcdhost", kv, "--bufgbytes",
                                            "0.001", "--dump-direct"])
        assert r["status"] == "normal" and r["response"]["ok"], r
        pl = PipelineControl(CorrControlClient(store=store, timeout_s=20.0),
                             host, 0)
        state = wait_for(lambda: pl.corr.get_status()["stats"]["state"]
                         == "running", 120, 0.2)
        assert state, "pipeline never ran"
        assert pl.corr.set_acc_length(480)["status"] == "normal"
        dump = tmp_path / "dump"
        dump.mkdir()
        assert pl.triggered_dump.trigger(ntime_per_file=96, nfile=2,
                                         dump_path=str(dump))["status"] \
            == "normal"
        files = wait_for(lambda: (lambda f: f if len(f) == 2 else None)(
            sorted(dump.glob("*.tbf"))), 60)
        assert files, "no dump files"
        assert wait_for(lambda: pl.triggered_dump.get_status()["stats"]
                        ["state"] == "idle", 30, 0.2)
        for f in files:
            hdr, data = TriggerFileSource(str(f)).read()
            assert hdr["ntime"] == 96 and data.shape == (96, 16, 32)
            # the ramp source: byte k of gulp i is (i * gulp_nbyte + k)
            i = hdr["seq0"] // 48
            flat = data.reshape(2, -1)
            n = flat.shape[1]
            for g in range(2):
                want = ((i + g) * n + np.arange(n)) & 0xFF
                np.testing.assert_array_equal(flat[g], want)
        r = manager_rpc(store, host, "stop_pipeline", "t", wait_s=60,
                        pipeline_id=0, timeout_s=30.0)
        assert r["status"] == "normal" and r["response"]["returncode"] == 0
    finally:
        if store is not None:
            store.close()
        mgr.send_signal(signal.SIGTERM)
        try:
            mgr.wait(timeout=30)
        except subprocess.TimeoutExpired:
            mgr.kill()
            mgr.wait()
        log.close()
    assert mgr.returncode == 0, (tmp_path / "manager.log").read_text()


def test_two_host_orchestration(tmp_path):
    """tests/test_multiprocess_system.py::test_two_host_manager_
    orchestration on the port: two managers (two "hosts", distinct xctrl
    keys) on one TCP store each start a port pipeline at the real-time
    rate of its small stream; the port's CorrelatorControl arms both on
    one start and verifies waiting -> running.  The JAX client reads the
    same status."""
    srv = StoreServer(port=0)
    kv = f"kv://127.0.0.1:{srv.port}"
    # 16 chan x 32 inputs x 23.926 kHz x 8 bit ~= 0.098 Gb/s: real time
    cmd = [sys.executable, "-m", "caltech_bifrost_dsp_tpu_torch.scripts."
           "pipeline"] + SMALL + ["--etcdhost", kv, "--target_throughput",
                                  "0.098"]
    hosts = ["xhost-a", "xhost-b"]
    ctls, svcs = [], []
    for host in hosts:
        pdir = tmp_path / host
        pdir.mkdir()
        ctl = XengineController(pidfile_dir=str(pdir), pipeline_cmd=cmd)
        ctl.hostname = host
        ctls.append(ctl)
        svcs.append(XengineManagerService(NetStore(port=srv.port), ctl))
    store = NetStore(port=srv.port)
    orig_popen = subprocess.Popen
    subprocess.Popen = lambda c, **kw: orig_popen(c, env=env(), cwd=REPO,
                                                  **kw)
    try:
        for i, host in enumerate(hosts):
            r = manager_rpc(store, host, "start_pipeline", f"s{i}",
                            pipeline_id=i)
            assert r["status"] == "normal" and r["response"]["ok"]
    finally:
        subprocess.Popen = orig_popen
    try:
        cli = CorrControlClient(store=NetStore(port=srv.port),
                                timeout_s=30.0)
        realhost = socket.gethostname()
        pls = [PipelineControl(cli, realhost, i) for i in range(2)]
        assert wait_for(lambda: all(p.corr.get_status()["stats"]["state"]
                                    for p in pls), 120, 0.3), \
            "pipelines never published"
        start = CorrelatorControl(cli, pls).arm_and_wait(delay_s=6.0,
                                                         timeout_s=90.0)
        assert start % 48 == 0
        jcli = jclient.CorrControlClient(store=store)
        for i, pl in enumerate(pls):
            st = pl.corr.get_status()["stats"]
            assert st["state"] == "running", st
            assert int(st["new_start_time"]) == start, st
            assert int(st["curr_sample"]) >= start, st
            jst = jclient.PipelineControl(jcli, realhost, i).corr \
                .get_status()["stats"]
            assert jst["new_start_time"] == st["new_start_time"]
    finally:
        for i, host in enumerate(hosts):
            try:
                manager_rpc(store, host, "stop_pipeline", f"t{i}",
                            pipeline_id=i)
            except AssertionError:
                ctls[i].kill_pipelines()
        for s in svcs:
            s.close()
        store.close()
        srv.close()
    for i, ctl in enumerate(ctls):
        assert not ctl.pipeline_is_up(i)


def test_chip_smoke_golden_gulp_files(tmp_path):
    """The golden vectors ``chip_smoke.py`` gives the CLI under the manager:
    ``in.dat`` is the reference generator's first gulp, and ``corr.dat``
    holds ``nrep`` times its exact correlation in the generator's layout,
    which is what the CLI's checkfile gate reads for a slow dump of
    ``nrep`` gulps of the looped file."""
    import torch

    import chip_smoke
    from caltech_bifrost_dsp_tpu_torch.config import XEngineConfig
    from caltech_bifrost_dsp_tpu_torch.verification import golden

    cfg = XEngineConfig(nstand=4, nchan=4, nbeam=2, ntime_gulp=6, acc_len=12,
                        acc_len_slow=24, ntime_sum=6, nchan_sum=2)
    din, dcorr, gulp = chip_smoke.golden_gulp_files(torch.device("cpu"), cfg,
                                                    tmp_path, nrep=3)
    golden.write_input_file(str(tmp_path / "ref.dat"), 6, 4, 4, 2, 6)
    assert din.read_bytes() == (tmp_path / "ref.dat").read_bytes()
    meta, corr = golden.read_dat(str(dcorr))
    assert meta["acc_len"] == 18 and corr.shape == (1, 4, 4, 4, 2, 2)
    want = 3 * golden.reference_correlation(gulp.reshape(6, 4, 4, 2))
    np.testing.assert_array_equal(corr[0], want)
