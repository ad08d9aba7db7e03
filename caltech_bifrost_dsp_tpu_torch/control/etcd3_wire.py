"""Minimal etcd v3 gRPC wire protocol: codec, client and server (port of
``caltech_bifrost_dsp_tpu/control/etcd3_wire.py``).

The reference's control plane is etcd3 (JSON commands over watched keys,
reference: pipeline-control/.../etcd_control.py:229-314).  This module
speaks the etcd v3 gRPC API directly over ``grpcio``, without
``python-etcd3``:

- a hand-rolled proto3 codec for the few ``etcdserverpb``/``mvccpb``
  messages the control plane needs (Put, Range, DeleteRange, Watch); the
  field numbers are those of the public etcd API (api/etcdserverpb/
  rpc.proto, api/mvccpb/kv.proto), varint and length-delimited fields
  only;
- :class:`Etcd3Client`, usable against an etcd cluster or the server
  below, with the ``put/get/get_prefix/delete/add_watch_prefix_callback``
  interface of ``control.store.MemoryStore``;
- :class:`Etcd3Server`, an etcd-protocol KV + Watch server over an
  in-process revisioned store, so the whole control plane runs over the
  etcd wire format without an etcd binary.

One gRPC ``Watch`` stream per prefix callback; events are delivered from a
reader thread, as python-etcd3 does.  ``grpc`` is imported only inside
:class:`Etcd3Client` and :class:`Etcd3Server`, so the module imports on a
host without it.
"""

from __future__ import annotations

import struct
import threading

# ---------------------------------------------------------------------------
# proto3 codec (varint + length-delimited fields only)


def _enc_varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v &= (1 << 64) - 1  # proto3 int64 negative -> 10-byte varint
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def enc_field(field: int, value) -> bytes:
    """Encode one field: int -> varint (wire type 0), bytes -> LEN (2)."""
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int):
        if value == 0:
            return b""  # proto3 default: omitted
        return _enc_varint((field << 3) | 0) + _enc_varint(value)
    if isinstance(value, (bytes, bytearray)):
        if not value:
            return b""
        return _enc_varint((field << 3) | 2) + _enc_varint(len(value)) \
            + bytes(value)
    raise TypeError(f"unsupported field type {type(value)}")


def enc_msg(*fields) -> bytes:
    """fields: (field_number, value) pairs; value None/0/b'' omitted."""
    out = bytearray()
    for num, val in fields:
        if val is None:
            continue
        out += enc_field(num, val)
    return bytes(out)


def dec_msg(buf: bytes) -> dict[int, list]:
    """Parse a message into {field_number: [values...]} (varint -> int,
    LEN -> bytes; groups/fixed are not used by these messages)."""
    out: dict[int, list] = {}
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _dec_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _dec_varint(buf, i)
        elif wt == 2:
            ln, i = _dec_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 1:
            v = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wt == 5:
            v = struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(field, []).append(v)
    return out


def _first(d: dict, field: int, default=None):
    return d[field][0] if field in d else default


# -- message helpers (field numbers per the public etcd v3 API) -------------

def enc_keyvalue(key: bytes, value: bytes, mod_revision: int = 0,
                 create_revision: int = 0, version: int = 0) -> bytes:
    return enc_msg((1, key), (2, create_revision), (3, mod_revision),
                   (4, version), (5, value))


def dec_keyvalue(buf: bytes) -> dict:
    d = dec_msg(buf)
    return {"key": _first(d, 1, b""), "create_revision": _first(d, 2, 0),
            "mod_revision": _first(d, 3, 0), "version": _first(d, 4, 0),
            "value": _first(d, 5, b"")}


def prefix_range_end(prefix: bytes) -> bytes:
    """etcd prefix convention: range_end = prefix with last byte + 1."""
    b = bytearray(prefix)
    for i in reversed(range(len(b))):
        if b[i] < 0xFF:
            b[i] += 1
            return bytes(b[:i + 1])
    return b"\x00"  # all-0xff prefix -> whole keyspace


_IDENT = (lambda b: b, lambda b: b)  # serializer pair: raw bytes through


def _grpc():
    """The ``grpc`` module, or an ImportError that says what needs it."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the etcd3 control store needs the grpc package (grpcio), which "
            "is not installed; use kv://HOST:PORT (the bundled TCP store) "
            "or no store host") from e
    return grpc


# ---------------------------------------------------------------------------
# client


class Etcd3Client:
    """etcd v3 KV + prefix-watch client over raw gRPC.

    Interface-compatible with ``control.store.MemoryStore`` (the shape
    ``control.command.CommandBlock`` consumes); values are str in/out.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 2379,
                 timeout_s: float = 5.0):
        grpc = _grpc()
        self._grpc = grpc
        self._chan = grpc.insecure_channel(f"{host}:{port}")
        self._timeout = timeout_s
        self._range = self._chan.unary_unary(
            "/etcdserverpb.KV/Range", *_IDENT)
        self._put = self._chan.unary_unary(
            "/etcdserverpb.KV/Put", *_IDENT)
        self._delete = self._chan.unary_unary(
            "/etcdserverpb.KV/DeleteRange", *_IDENT)
        self._watches: dict[int, tuple] = {}
        self._watch_id = 0
        self._lock = threading.Lock()

    # -- KV -----------------------------------------------------------------

    def put(self, key: str, value: str) -> None:
        req = enc_msg((1, key.encode()), (2, value.encode()))
        self._put(req, timeout=self._timeout)

    def get(self, key: str) -> str | None:
        req = enc_msg((1, key.encode()),)
        d = dec_msg(self._range(req, timeout=self._timeout))
        kvs = d.get(2, [])
        if not kvs:
            return None
        return dec_keyvalue(kvs[0])["value"].decode()

    def get_prefix(self, prefix: str) -> dict[str, str]:
        req = enc_msg((1, prefix.encode()),
                      (2, prefix_range_end(prefix.encode())))
        d = dec_msg(self._range(req, timeout=self._timeout))
        out = {}
        for raw in d.get(2, []):
            kv = dec_keyvalue(raw)
            out[kv["key"].decode()] = kv["value"].decode()
        return out

    def delete(self, key: str) -> None:
        req = enc_msg((1, key.encode()),)
        self._delete(req, timeout=self._timeout)

    # -- watches ------------------------------------------------------------

    def add_watch_prefix_callback(self, prefix: str, callback) -> int:
        """Start a Watch stream for the prefix; events fire ``callback``
        with a MemoryStore-shaped WatchResponse (``.events`` of
        ``.key``/``.value`` str attributes)."""
        from .store import Event, WatchResponse

        create = enc_msg((1, prefix.encode()),
                         (2, prefix_range_end(prefix.encode())))
        req = enc_msg((1, create),)  # WatchRequest.create_request
        started = threading.Event()

        def feed():
            yield req
            started.wait()  # keep the request side open until cancel
            # returning ends the stream (etcd treats it as client close)

        call = self._chan.stream_stream(
            "/etcdserverpb.Watch/Watch", *_IDENT)(feed())
        created = threading.Event()

        def reader():
            try:
                for raw in call:
                    d = dec_msg(raw)
                    if _first(d, 3, 0):  # created ack: watch is live
                        created.set()
                    events = []
                    for ev_raw in d.get(11, []):
                        ev = dec_msg(ev_raw)
                        if _first(ev, 1, 0) != 0:
                            continue  # DELETE events not consumed
                        kv = dec_keyvalue(_first(ev, 2, b""))
                        events.append(Event(kv["key"].decode(),
                                            kv["value"].decode()))
                    if events:
                        callback(WatchResponse(events))
            except self._grpc.RpcError:
                pass  # cancelled / channel closed

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        # block until the server acks the watch: a put issued right
        # after this call must be observed (python-etcd3 behaves the
        # same way via its watch-established handshake)
        created.wait(self._timeout)
        with self._lock:
            self._watch_id += 1
            self._watches[self._watch_id] = (call, th, started)
            return self._watch_id

    def cancel_watch(self, watch_id: int) -> None:
        with self._lock:
            entry = self._watches.pop(watch_id, None)
        if entry:
            call, th, started = entry
            call.cancel()
            started.set()
            th.join(timeout=2.0)

    def close(self) -> None:
        with self._lock:
            ids = list(self._watches)
        for wid in ids:
            self.cancel_watch(wid)
        self._chan.close()


# ---------------------------------------------------------------------------
# server


class Etcd3Server:
    """etcd-protocol KV + Watch server backed by a revisioned in-process
    store.  Implements the subset of ``etcdserverpb`` the control plane
    uses (Put / Range incl. prefix / DeleteRange / streaming Watch with
    create+cancel), enough for this package's client AND stock etcd
    clients to operate against."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import atexit

        from concurrent import futures

        grpc = _grpc()

        self._data: dict[bytes, tuple[bytes, int, int, int]] = {}
        # key -> (value, create_rev, mod_rev, version)
        self._rev = 1
        self._lock = threading.Lock()
        self._watchers: dict[int, tuple] = {}  # id -> (key, end, queue)
        self._next_watcher = 1
        self._streams: set = set()  # live watch-handler queues
        self._stopped = False
        # a live Watch handler occupies a (non-daemon) executor thread;
        # unblock them at interpreter exit or futures' atexit join hangs
        atexit.register(self.stop)

        svr = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        kv = grpc.method_handlers_generic_handler("etcdserverpb.KV", {
            "Range": grpc.unary_unary_rpc_method_handler(
                self._handle_range, *_IDENT),
            "Put": grpc.unary_unary_rpc_method_handler(
                self._handle_put, *_IDENT),
            "DeleteRange": grpc.unary_unary_rpc_method_handler(
                self._handle_delete, *_IDENT),
        })
        watch = grpc.method_handlers_generic_handler("etcdserverpb.Watch", {
            "Watch": grpc.stream_stream_rpc_method_handler(
                self._handle_watch, *_IDENT),
        })
        svr.add_generic_rpc_handlers((kv, watch))
        self.port = svr.add_insecure_port(f"{host}:{port}")
        self._server = svr
        svr.start()

    # -- internals ----------------------------------------------------------

    def _header(self) -> bytes:
        return enc_msg((1, 1), (2, 1), (3, self._rev), (4, 1))

    @staticmethod
    def _in_range(key: bytes, start: bytes, end: bytes) -> bool:
        if not end:
            return key == start
        if end == b"\x00":
            return key >= start
        return start <= key < end

    def _handle_range(self, req: bytes, ctx) -> bytes:
        d = dec_msg(req)
        key, end = _first(d, 1, b""), _first(d, 2, b"")
        with self._lock:
            kvs = [enc_keyvalue(k, v[0], v[2], v[1], v[3])
                   for k, v in sorted(self._data.items())
                   if self._in_range(k, key, end)]
            hdr = self._header()
        fields = [(1, hdr)] + [(2, kv) for kv in kvs] \
            + [(4, len(kvs))]
        return enc_msg(*fields)

    def _handle_put(self, req: bytes, ctx) -> bytes:
        d = dec_msg(req)
        key, value = _first(d, 1, b""), _first(d, 2, b"")
        with self._lock:
            self._rev += 1
            prev = self._data.get(key)
            create = prev[1] if prev else self._rev
            version = prev[3] + 1 if prev else 1
            self._data[key] = (value, create, self._rev, version)
            kv_enc = enc_keyvalue(key, value, self._rev, create, version)
            event = enc_msg((1, 0), (2, kv_enc))  # type=PUT
            hdr = self._header()
            # deliver while still holding the lock: appends then happen in
            # revision order, matching etcd's ordered-watch-stream contract
            # (two concurrent puts must not reach a watcher reversed)
            for wid, (s, e, q) in self._watchers.items():
                if self._in_range(key, s, e):
                    q.append((wid, event))
        return enc_msg((1, hdr))

    def _handle_delete(self, req: bytes, ctx) -> bytes:
        d = dec_msg(req)
        key, end = _first(d, 1, b""), _first(d, 2, b"")
        with self._lock:
            victims = [k for k in self._data
                       if self._in_range(k, key, end)]
            for k in victims:
                del self._data[k]
            self._rev += 1
            hdr = self._header()
        return enc_msg((1, hdr), (2, len(victims)))

    def _handle_watch(self, request_iterator, ctx):
        import queue as _queue

        events: _queue.Queue = _queue.Queue()
        my_ids: list[int] = []
        with self._lock:
            if self._stopped:
                return
            self._streams.add(events)

        class _Sink(list):
            def append(self, item):  # store-side push -> stream queue
                events.put(item)

        def reader():
            try:
                for raw in request_iterator:
                    d = dec_msg(raw)
                    if 1 in d:  # create_request
                        cd = dec_msg(d[1][0])
                        start = _first(cd, 1, b"")
                        end = _first(cd, 2, b"")
                        with self._lock:
                            wid = self._next_watcher
                            self._next_watcher += 1
                            self._watchers[wid] = (start, end, _Sink())
                            my_ids.append(wid)
                        events.put(("created", wid))
                    elif 2 in d:  # cancel_request
                        cd = dec_msg(d[2][0])
                        wid = _first(cd, 1, 0)
                        with self._lock:
                            self._watchers.pop(wid, None)
                        events.put(("canceled", wid))
            except Exception:
                pass
            finally:
                events.put(None)

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        try:
            while True:
                item = events.get()
                if item is None:
                    break
                if item[0] == "created":
                    yield enc_msg((1, self._header()), (2, item[1]),
                                  (3, 1))
                elif item[0] == "canceled":
                    yield enc_msg((1, self._header()), (2, item[1]),
                                  (4, 1))
                else:
                    wid, ev = item
                    yield enc_msg((1, self._header()), (2, wid),
                                  (11, ev))
        finally:
            with self._lock:
                self._streams.discard(events)
                for wid in my_ids:
                    self._watchers.pop(wid, None)

    def stop(self, grace: float = 0.5) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            streams = list(self._streams)
        for q in streams:
            q.put(None)  # release the watch handlers' executor threads
        self._server.stop(grace)
