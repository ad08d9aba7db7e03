"""Monitoring bridge: proclogs -> control store (port of
``caltech_bifrost_dsp_tpu/control/monitor.py``).

The reference runs a daemon that polls the bifrost proclogs, derives rates
from byte-counter deltas and publishes JSON under ``/mon/corr/...``
(reference: pipeline-control/scripts/bifrost_etcd_bridge.py:14,101-161).
Here the bridge reads the in-process registry of :mod:`..utils.proclog`
and publishes to any store with the MemoryStore interface.
"""

from __future__ import annotations

import json
import socket
import threading
import time

from ..utils.proclog import registry_snapshot


class MonitorBridge:
    def __init__(self, store, pipeline_id: int = 0,
                 keyroot: str = "/mon/corr", host: str | None = None,
                 poll_s: float = 2.0):
        self.store = store
        self.pipeline_id = pipeline_id
        self.keyroot = keyroot
        self.host = host or socket.gethostname()
        self.poll_s = poll_s
        self._prev_bytes: dict[str, tuple[float, float]] = {}
        self._baseline_hash: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def publish_once(self) -> dict:
        """Publish one snapshot; returns {key: payload} of what was put."""
        now = time.time()
        blocks: dict[str, dict] = {}
        for name, data in registry_snapshot().items():
            block, _, kind = name.partition("/")
            blocks.setdefault(block, {})[kind or "misc"] = data
        out = {}
        for block, kinds in blocks.items():
            # "<Block>.<n>" names carry the instance id of a block's 2nd+
            # instance; each publishes under its own .../<Block>/<n> key
            bname, _, inst = block.partition(".")
            inst_id = int(inst) if inst else 0
            payload = {"time": now, "host": self.host,
                       "pid": self.pipeline_id, "block": bname,
                       "instance": inst_id}
            payload.update(kinds)
            # sequence-header fields at top level: the arming arithmetic
            # reads sync_time/bw_hz/nchan off the status
            # (corr_control.py:49-57)
            payload.update(kinds.get("sequence0", {}))
            stats = kinds.get("stats", {})
            nbyte = stats.get("ngood_bytes")
            if nbyte is not None:
                # rate from byte-counter deltas (bifrost_etcd_bridge.py:
                # 127-139)
                prev = self._prev_bytes.get(block)
                if prev is not None and now > prev[0]:
                    payload["gbps"] = (8 * (nbyte - prev[1])
                                       / (now - prev[0]) / 1e9)
                self._prev_bytes[block] = (now, nbyte)
            key = (f"{self.keyroot}/x/{self.host}/pipeline/"
                   f"{self.pipeline_id}/{bname}/{inst_id}/status")
            # the big baseline list goes to a sub-key, only on change
            # (bifrost_etcd_bridge.py:148-160)
            bl = stats.pop("baselines", None)
            if bl is not None:
                h = hash(json.dumps(bl))
                if self._baseline_hash.get(block) != h:
                    self._baseline_hash[block] = h
                    self.store.put(key + "/baselines", json.dumps(bl))
            self.store.put(key, json.dumps(payload))
            out[key] = payload
        return out

    def start(self) -> None:
        def _loop():
            while not self._stop.wait(self.poll_s):
                self.publish_once()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="monitor-bridge")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
