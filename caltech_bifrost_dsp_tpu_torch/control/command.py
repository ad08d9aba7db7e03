"""Typed command-key registry with pending->active staging (port of
``caltech_bifrost_dsp_tpu/control/command.py``).

Protocol of the reference's per-block control (reference:
blocks/block_base.py):

- key schema ``<root>/x/<host>/pipeline/<pid>/<block>/<id>``
  (block_base.py:127-144);
- JSON command envelope ``{"cmd": "update", "id": seq, "val": {"kwargs":
  {...}}}`` with per-key type and condition validation
  (block_base.py:216-347);
- response envelope ``{"id", "val": {"status", "response", "timestamp"}}``
  with status codes OK=0 / NOT_RECOGNIZED=-1 / WRONG_TYPE=-2 / INVALID=-3;
- staged application: accepted values wait in a pending dict and take
  effect when the data path calls :meth:`CommandBlock.update_command_vals`
  at a gulp boundary, under a control lock (block_base.py:296-365);
  ``apply_immediately=True`` applies on receipt (the Beamform override,
  beamform_block.py:269-318).

A command is validated whole before any key is staged, so a rejected
command changes nothing.
"""

from __future__ import annotations

import json
import socket
import threading
import time

from ..utils.proclog import ProcLog
from .store import Event, WatchResponse

COMMAND_OK = 0
COMMAND_NOT_RECOGNIZED = -1
COMMAND_WRONG_TYPE = -2
COMMAND_INVALID = -3


def block_key(root: str, host: str, pipeline_id: int, block: str,
              instance_id: int) -> str:
    return f"{root}/x/{host}/pipeline/{pipeline_id}/{block}/{instance_id}"


class CommandBlock:
    """Control/monitoring endpoint for one pipeline stage."""

    pipeline_id = 0
    _instance_counts: dict[str, int] = {}

    @classmethod
    def set_id(cls, x: int) -> None:
        CommandBlock.pipeline_id = x

    @classmethod
    def reset_instance_counts(cls) -> None:
        """Restart the per-name instance counters (a new pipeline process
        starts at 0, block_base.py:85-93)."""
        CommandBlock._instance_counts.clear()

    def __init__(self, name: str, store=None, log=None,
                 command_keyroot: str = "/cmd/corr",
                 monitor_keyroot: str = "/mon/corr",
                 response_keyroot: str = "/resp/corr",
                 apply_immediately: bool = False,
                 host: str | None = None):
        self.name = name
        self.store = store
        self.log = log
        cnt = CommandBlock._instance_counts.get(name, -1) + 1
        CommandBlock._instance_counts[name] = cnt
        self.instance_id = cnt
        host = host or socket.gethostname()
        self.command_key = block_key(command_keyroot, host,
                                     self.pipeline_id, name, cnt)
        self.monitor_key = block_key(monitor_keyroot, host,
                                     self.pipeline_id, name, cnt)
        self.response_key = block_key(response_keyroot, host,
                                      self.pipeline_id, name, cnt)
        self.stats: dict = {}
        # a second instance of a name logs under "<name>.<id>"
        logname = f"{name}.{cnt}" if cnt else name
        self.stats_proclog = ProcLog(f"{logname}/stats")
        self.perf_proclog = ProcLog(f"{logname}/perf")
        self.sequence_proclog = ProcLog(f"{logname}/sequence0")
        self.update_pending = False
        self.command_vals: dict = {}
        self._pending_command_vals: dict = {}
        self._unapplied_keys: set = set()
        self._command_types: dict = {}
        self._command_conditions: dict = {}
        self._apply_immediately = apply_immediately
        self._control_lock = threading.Lock()
        self._on_command_applied = None  # hook for immediate-mode blocks
        self._watch_id = None
        if self.store is not None:
            self._watch_id = self.store.add_watch_prefix_callback(
                self.command_key, self._watch_callback)

    # -- key definition -------------------------------------------------------

    def define_command_key(self, name, type=None, condition=None,
                           initial_val=None):
        """(block_base.py:162-192, with its initial-value checks)"""
        if initial_val:
            if type and not isinstance(initial_val, type):
                raise TypeError(f"{self.name}: key {name}: initial value "
                                "type check fail")
            if condition and not condition(initial_val):
                raise ValueError(f"{self.name}: key {name}: initial value "
                                 "failed condition")
        self.command_vals[name] = initial_val
        self._pending_command_vals[name] = initial_val
        self._command_types[name] = type
        self._command_conditions[name] = condition

    # -- command ingestion ----------------------------------------------------

    def process_command_strings(self, cmds) -> None:
        """Take command JSON strings as if they had arrived over the store
        (the reference's path that bypasses etcd, block_base.py:194-214);
        used with ``CorrControlClient(simulated=True)``."""
        if not isinstance(cmds, list):
            cmds = [cmds]
        self._watch_callback(WatchResponse([Event("", c) for c in cmds]))

    def _watch_callback(self, watchresponse) -> None:
        with self._control_lock:
            for event in watchresponse.events:
                try:
                    v = json.loads(event.value)
                except (ValueError, TypeError):
                    self._send_command_response("0", False,
                                                "JSON-decode failed!")
                    continue
                seq_id = v.get("id", None)
                if seq_id is None:
                    self._send_command_response("0", False,
                                                "Missing ID field")
                    continue
                if v.get("cmd", None) != "update":
                    self._send_command_response("0", False,
                                                "Invalid command")
                    continue
                val = v.get("val", None)
                if not isinstance(val, dict):
                    self._send_command_response(
                        seq_id, False, "`val` field should be a dictionary")
                    continue
                update_keys = val.get("kwargs", None)
                if not isinstance(update_keys, dict):
                    self._send_command_response(
                        seq_id, False,
                        "`val[kwargs]` field should be a dictionary")
                    continue
                try:
                    proc_ok = self._process_commands(
                        update_keys,
                        set_pending_flag=not self._apply_immediately)
                except Exception:  # noqa: BLE001 - a condition that raised
                    proc_ok = COMMAND_INVALID
                self.stats["last_cmd_response"] = proc_ok
                if self._apply_immediately and proc_ok == COMMAND_OK:
                    self._update_command_vals_locked()
                self._send_command_response(seq_id,
                                            proc_ok == COMMAND_OK,
                                            str(proc_ok))
        self.update_stats({})

    def _process_commands(self, command_dict, set_pending_flag=True) -> int:
        """Validate every key, then stage the whole command."""
        for key, value in command_dict.items():
            if key not in self.command_vals:
                return COMMAND_NOT_RECOGNIZED
            ktype = self._command_types[key]
            if ktype and not isinstance(value, ktype):
                return COMMAND_WRONG_TYPE
            cond = self._command_conditions[key]
            if cond and not cond(value):
                return COMMAND_INVALID
        for key, value in command_dict.items():
            self._pending_command_vals[key] = value
            self._unapplied_keys.add(key)
            self.stats["new_" + key] = value
        if set_pending_flag:
            self.update_pending = True
        self.stats["update_pending"] = True
        self.stats["last_cmd_time"] = time.time()
        return COMMAND_OK

    def _send_command_response(self, seq_id, processed_ok, response):
        resp = {"id": seq_id,
                "val": {"status": "normal" if processed_ok else "error",
                        "response": response,
                        "timestamp": time.time()}}
        if self.store is not None:
            self.store.put(self.response_key, json.dumps(resp))
        elif self.log is not None:
            self.log.info("No control store: command response: %s", resp)

    # -- data-path side -------------------------------------------------------

    def _update_command_vals_locked(self):
        self.command_vals.update(self._pending_command_vals)
        self.update_pending = False
        self.stats["update_pending"] = False
        self.stats["last_cmd_proc_time"] = time.time()
        # the hook sees only the keys accepted since the last apply, so a
        # one-shot key never fires twice
        delta = {k: self._pending_command_vals[k]
                 for k in self._unapplied_keys}
        self._unapplied_keys.clear()
        if self._on_command_applied is not None and delta:
            try:
                self._on_command_applied(delta)
            except Exception as e:  # noqa: BLE001 - keep the watch alive
                # immediate-apply hooks run on the store's watch thread;
                # an escaping exception would end command processing for
                # every block
                self.stats["last_cmd_error"] = str(e)
                if self.log is not None:
                    self.log.error("%s >> command apply hook failed: %s",
                                   self.name, e)

    def update_command_vals(self) -> None:
        with self._control_lock:
            self._update_command_vals_locked()
        self.update_stats(self.command_vals)

    def update_stats(self, new_stats: dict | None = None) -> None:
        """(block_base.py:374-387)"""
        if new_stats:
            self.stats.update(new_stats)
        self.stats_proclog.update(self.stats)

    def close(self) -> None:
        if self._watch_id is not None and self.store is not None:
            self.store.cancel_watch(self._watch_id)
            self._watch_id = None
