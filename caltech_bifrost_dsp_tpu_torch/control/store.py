"""etcd-shaped key-value store with prefix watches (port of
``caltech_bifrost_dsp_tpu/control/store.py``).

The reference's control plane is etcd3: blocks watch command keys and put
status/response keys (reference: blocks/block_base.py:151-153).  The port
has the in-process :class:`MemoryStore` (the analog of
``EtcdCorrControl(simulated=True)``); the etcd wire client and the bundled
TCP store are not ported, and :func:`connect` refuses a host.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class Event:
    key: str
    value: str


class WatchResponse:
    def __init__(self, events):
        self.events = list(events)


class MemoryStore:
    """Thread-safe KV store with add_watch_prefix_callback semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: dict[str, str] = {}
        self._watches: dict[int, tuple[str, callable]] = {}
        self._watch_id = 0

    def put(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value
            watchers = [cb for prefix, cb in self._watches.values()
                        if key.startswith(prefix)]
        # callbacks run outside the lock, like etcd3's watch thread
        for cb in watchers:
            cb(WatchResponse([Event(key, value)]))

    def get(self, key: str) -> str | None:
        with self._lock:
            return self._data.get(key)

    def get_prefix(self, prefix: str) -> dict[str, str]:
        with self._lock:
            return {k: v for k, v in self._data.items()
                    if k.startswith(prefix)}

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def add_watch_prefix_callback(self, prefix: str, callback) -> int:
        with self._lock:
            self._watch_id += 1
            self._watches[self._watch_id] = (prefix, callback)
            return self._watch_id

    def cancel_watch(self, watch_id: int) -> None:
        with self._lock:
            self._watches.pop(watch_id, None)


def connect(host: str | None = None, port: int = 2379) -> MemoryStore:
    """Store factory: ``None`` gives an in-process MemoryStore.  etcd and
    the ``kv://`` TCP store are not ported yet."""
    if host:
        raise NotImplementedError(
            f"control store {host!r}: etcd and kv:// stores are not ported "
            "yet; only the in-process store (no host) is")
    return MemoryStore()
