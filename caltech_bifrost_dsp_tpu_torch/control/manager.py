"""Per-server pipeline process manager (port of
``caltech_bifrost_dsp_tpu/control/manager.py``).

The reference's ``LwaXengineEtcdClient``/``XengineController`` daemon
(pipeline-control/lwa352_pipeline_control/lwa352_xeng_etcd_client.py):
watches a per-host command key, dispatches RPCs by method name (private
methods are not callable remotely, lines 234-246) and starts, stops and
polls pipeline subprocesses with pidfiles (lines 283-388).  Pipelines are
pinned with ``taskset`` where a core list is configured (the reference's
per-server NUMA tables, lines 16-26).  The default pipeline command is the
port's CLI, ``caltech_bifrost_dsp_tpu_torch.scripts.pipeline``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time


class XengineController:
    """Start/stop/poll pipeline subprocesses on this host."""

    def __init__(self, ncpu_per_pipeline: int = 0, pidfile_dir: str = "/tmp",
                 pipeline_cmd: list[str] | None = None,
                 cpu_tables: dict[int, list[int]] | None = None):
        self.hostname = socket.gethostname()
        self.pidfile_dir = pidfile_dir
        self.pipeline_cmd = pipeline_cmd or [
            sys.executable, "-m",
            "caltech_bifrost_dsp_tpu_torch.scripts.pipeline"]
        self.cpu_tables = cpu_tables or {}
        self.procs: dict[int, subprocess.Popen] = {}

    def _pidfile(self, pipeline_id: int) -> str:
        return os.path.join(self.pidfile_dir,
                            f"cbd-tpu-pipeline-{pipeline_id}.pid")

    def start_pipeline(self, pipeline_id: int, extra_args: list[str]
                       | None = None) -> dict:
        if self.pipeline_is_up(pipeline_id):
            return {"ok": False, "err": "already running"}
        cmd = list(self.pipeline_cmd) + ["--pipelineid", str(pipeline_id)]
        cores = self.cpu_tables.get(pipeline_id)
        if cores:
            cmd = ["taskset", "-c",
                   ",".join(map(str, cores))] + cmd
        if extra_args:
            cmd += list(extra_args)
        proc = subprocess.Popen(cmd)
        self.procs[pipeline_id] = proc
        with open(self._pidfile(pipeline_id), "w") as fh:
            fh.write(str(proc.pid))
        return {"ok": True, "pid": proc.pid}

    def stop_pipeline(self, pipeline_id: int, timeout_s: float = 10.0
                      ) -> dict:
        """SIGTERM, then SIGKILL after ``timeout_s``.  For a pipeline this
        controller started, the response carries its ``returncode``."""
        pid = self.get_pid(pipeline_id)
        if pid is None:
            return {"ok": False, "err": "not running"}
        proc = self.procs.get(pipeline_id)
        try:
            os.kill(pid, signal.SIGTERM)
            deadline = time.time() + timeout_s
            while time.time() < deadline:
                if proc is not None:
                    # our own child: reap it; a terminated child stays a
                    # zombie until waited on, and os.kill(pid, 0) succeeds
                    # on zombies
                    if proc.poll() is not None:
                        break
                elif not self._pid_alive(pid):
                    break
                time.sleep(0.1)
            else:
                os.kill(pid, signal.SIGKILL)
                if proc is not None:
                    proc.wait(timeout=5.0)
        except ProcessLookupError:
            pass
        try:
            os.remove(self._pidfile(pipeline_id))
        except FileNotFoundError:
            pass
        self.procs.pop(pipeline_id, None)
        if proc is None:
            return {"ok": True}
        # the pipeline's exit code (negative: the signal that ended it)
        return {"ok": True, "returncode": proc.returncode}

    def kill_pipelines(self) -> dict:
        """Stop everything this controller started (the reference's
        kill/restart RPC, lwa352_xeng_etcd_client.py:334-341)."""
        out = {}
        for pid in list(self.procs):
            out[pid] = self.stop_pipeline(pid)
        return {"ok": True, "stopped": out}

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False

    def get_pid(self, pipeline_id: int) -> int | None:
        proc = self.procs.get(pipeline_id)
        if proc is not None and proc.poll() is None:
            return proc.pid
        try:
            with open(self._pidfile(pipeline_id)) as fh:
                pid = int(fh.read().strip())
            return pid if self._pid_alive(pid) else None
        except (FileNotFoundError, ValueError):
            return None

    def pipeline_is_up(self, pipeline_id: int) -> bool:
        return self.get_pid(pipeline_id) is not None

    def status(self) -> dict:
        return {"host": self.hostname,
                "pipelines": {i: self.pipeline_is_up(i)
                              for i in sorted(set(
                                  list(self.procs)
                                  + list(self.cpu_tables)))}}


class XengineManagerService:
    """RPC endpoint: watches ``/cmd/corr/x/<host>/xctrl`` and dispatches
    commands by method name onto an :class:`XengineController`
    (lwa352_xeng_etcd_client.py:221-281)."""

    def __init__(self, store, controller: XengineController,
                 cmd_root: str = "/cmd/corr", resp_root: str = "/resp/corr"):
        self.store = store
        self.controller = controller
        host = controller.hostname
        self.cmd_key = f"{cmd_root}/x/{host}/xctrl"
        self.resp_key = f"{resp_root}/x/{host}/xctrl"
        self._watch_id = store.add_watch_prefix_callback(
            self.cmd_key, self._callback)

    def _callback(self, watchresponse):
        for event in watchresponse.events:
            try:
                v = json.loads(event.value)
            except (ValueError, TypeError):
                self._respond("0", False, "JSON decode error")
                continue
            seq_id = str(v.get("id", "0"))
            cmd = v.get("cmd", "")
            kwargs = (v.get("val") or {}).get("kwargs", {}) or {}
            # underscore guard: private methods are not remotely callable
            # (lwa352_xeng_etcd_client.py:234-246)
            if cmd.startswith("_") or not hasattr(self.controller, cmd):
                self._respond(seq_id, False, f"no such command {cmd!r}")
                continue
            try:
                rv = getattr(self.controller, cmd)(**kwargs)
                self._respond(seq_id, True, rv)
            except Exception as exc:  # report, don't die
                self._respond(seq_id, False, str(exc))

    def _respond(self, seq_id, ok, response):
        self.store.put(self.resp_key, json.dumps({
            "id": seq_id,
            "val": {"status": "normal" if ok else "error",
                    "response": response, "timestamp": time.time()}}))

    def close(self):
        self.store.cancel_watch(self._watch_id)
