"""Self-contained network KV store with prefix watches (port of
``caltech_bifrost_dsp_tpu/control/netstore.py``, the same wire format byte
for byte, so a pipeline of either package and an operator client of the
other can share one store).

The reference's control plane needs an external etcd service; this store
speaks the MemoryStore interface over TCP (newline-delimited JSON), so a
host manager and its pipeline subprocesses work without any service of
their own.  Several hosts use etcd (:func:`..store.Etcd3Store`).

Protocol: the client sends {"op": "put"|"get"|"get_prefix"|"delete"|
"watch", ...}; for "watch" the connection stays open and the server
streams {"event": {"key", "value"}} lines for keys under the prefix.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading


class _Hub:
    def __init__(self):
        self.lock = threading.Lock()
        self.data: dict[str, str] = {}
        self.watchers: list[tuple[str, object]] = []  # (prefix, wfile)

    def put(self, key, value):
        with self.lock:
            self.data[key] = value
            dead = []
            for prefix, wfile in self.watchers:
                if key.startswith(prefix):
                    try:
                        wfile.write((json.dumps(
                            {"event": {"key": key, "value": value}})
                            + "\n").encode())
                        wfile.flush()
                    except (OSError, ValueError):
                        # OSError: connection reset / send timeout (the
                        # per-watcher socket timeout bounds how long a
                        # stalled watcher can hold the hub lock).
                        # ValueError: writing to a wfile the handler
                        # already closed after client EOF — without
                        # catching it the stale entry was never pruned
                        # and EVERY later put to this prefix died.
                        dead.append((prefix, wfile))
            for d in dead:
                self.watchers.remove(d)


class StoreServer:
    """Threaded TCP KV server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        hub = _Hub()
        self.hub = hub

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    try:
                        req = json.loads(line.decode())
                    except ValueError:
                        continue
                    op = req.get("op")
                    if op == "put":
                        hub.put(req["key"], req["value"])
                        self._reply({"ok": True})
                    elif op == "get":
                        with hub.lock:
                            self._reply({"value":
                                         hub.data.get(req["key"])})
                    elif op == "get_prefix":
                        with hub.lock:
                            vals = {k: v for k, v in hub.data.items()
                                    if k.startswith(req["prefix"])}
                        self._reply({"values": vals})
                    elif op == "delete":
                        with hub.lock:
                            hub.data.pop(req["key"], None)
                        self._reply({"ok": True})
                    elif op == "watch":
                        # bound event SENDS only (SO_SNDTIMEO, not a
                        # python-level socket timeout, which would also
                        # time out the handler's idle read loop and
                        # close the watch): a watcher that stops
                        # reading must not block hub.put (which holds
                        # the hub lock) forever — after 5 s its send
                        # fails and the watcher is pruned
                        import struct as _struct
                        self.connection.setsockopt(
                            socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            _struct.pack("ll", 5, 0))
                        with hub.lock:
                            hub.watchers.append((req["prefix"],
                                                 self.wfile))
                            # ack under the hub lock: a concurrent
                            # put() would otherwise stream an event
                            # line onto this wfile BEFORE the ack, and
                            # the client's single readline() ack
                            # consume would eat the event (watches use
                            # a dedicated connection, so after this
                            # ack hub.put is the only writer)
                            self._reply({"ok": True})
                        # keep the connection open; events stream on it
                    else:
                        self._reply({"err": f"bad op {op!r}"})

            def _reply(self, obj):
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="kv-store-server")
        self._thread.start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()


class NetStore:
    """Client with the MemoryStore interface."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4440,
                 timeout_s: float = 5.0):
        self.addr = (host, port)
        self.timeout_s = timeout_s
        self._sock = socket.create_connection(self.addr, timeout_s)
        self._fh = self._sock.makefile("rwb")
        self._lock = threading.Lock()
        self._watch_id = 0
        self._watches: dict[int, threading.Thread] = {}
        self._watch_socks: dict[int, socket.socket] = {}

    def _rpc(self, req: dict) -> dict:
        with self._lock:
            self._fh.write((json.dumps(req) + "\n").encode())
            self._fh.flush()
            line = self._fh.readline()
        return json.loads(line.decode())

    def put(self, key, value):
        self._rpc({"op": "put", "key": key, "value": value})

    def get(self, key):
        return self._rpc({"op": "get", "key": key})["value"]

    def get_prefix(self, prefix):
        return self._rpc({"op": "get_prefix", "prefix": prefix})["values"]

    def delete(self, key):
        self._rpc({"op": "delete", "key": key})

    def add_watch_prefix_callback(self, prefix, callback) -> int:
        from .store import Event, WatchResponse

        sock = socket.create_connection(self.addr, self.timeout_s)
        fh = sock.makefile("rwb")
        fh.write((json.dumps({"op": "watch", "prefix": prefix})
                  + "\n").encode())
        fh.flush()
        fh.readline()  # ack
        # the connect/handshake timeout must NOT persist on the event
        # stream: an idle watch would hit the 5 s recv timeout
        # (TimeoutError is an OSError, swallowed below) and the watch
        # thread died silently while still registered — the client
        # stopped receiving commands 5 s after the last event
        sock.settimeout(None)

        def _loop():
            try:
                for line in fh:
                    try:
                        msg = json.loads(line.decode())
                    except ValueError:
                        continue
                    ev = msg.get("event")
                    if ev:
                        callback(WatchResponse(
                            [Event(ev["key"], ev["value"])]))
            except (OSError, ValueError):
                pass  # cancel_watch closed the socket under us

        th = threading.Thread(target=_loop, daemon=True,
                              name=f"kv-watch-{prefix}")
        th.start()
        self._watch_id += 1
        self._watches[self._watch_id] = th
        self._watch_socks[self._watch_id] = sock
        return self._watch_id

    def cancel_watch(self, watch_id: int):
        sock = self._watch_socks.pop(watch_id, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._watches.pop(watch_id, None)

    def close(self):
        for wid in list(self._watch_socks):
            self.cancel_watch(wid)
        try:
            self._sock.close()
        except OSError:
            pass
