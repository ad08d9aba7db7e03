"""etcd-shaped key-value store with prefix watches (port of
``caltech_bifrost_dsp_tpu/control/store.py``).

The reference's control plane is etcd3: blocks watch command keys and put
status/response keys (reference: blocks/block_base.py:151-153).  Three
stores share one interface (``put``/``get``/``get_prefix``/``delete``/
``add_watch_prefix_callback``/``cancel_watch``), chosen by :func:`connect`:

- :class:`MemoryStore`, in process (the analog of
  ``EtcdCorrControl(simulated=True)``, etcd_control.py:276-277);
- :class:`.netstore.NetStore`, the bundled TCP store (``kv://HOST:PORT``),
  for several processes on one host without etcd;
- :class:`.etcd3_wire.Etcd3Client`, the etcd v3 gRPC wire protocol spoken
  over ``grpcio``, against an etcd cluster or the bundled
  :class:`.etcd3_wire.Etcd3Server`.  ``grpc`` is imported only when such a
  client is made.
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


def Etcd3Store(host: str = "localhost", port: int = 2379):
    """etcd3 client with the MemoryStore interface (the etcd v3 gRPC wire
    protocol over ``grpcio``, :class:`.etcd3_wire.Etcd3Client`)."""
    from .etcd3_wire import Etcd3Client

    return Etcd3Client(host, port)


def connect(host: str | None = None, port: int = 2379):
    """Store factory.

    - ``None`` (or "") -> an in-process :class:`MemoryStore`;
    - ``"kv://HOST:PORT"`` -> the bundled TCP store (:mod:`.netstore`);
    - anything else -> an etcd3 wire client at ``host``:``port``; without
      ``grpc`` this raises ``ImportError``.
    """
    if not host:
        return MemoryStore()
    if host.startswith("kv://"):
        from .netstore import NetStore

        h, _, p = host[5:].partition(":")
        return NetStore(h or "127.0.0.1", int(p or 4440))
    return Etcd3Store(host, port)
