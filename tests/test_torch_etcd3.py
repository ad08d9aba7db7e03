"""The port's etcd v3 wire protocol (``control/etcd3_wire.py``) against the
JAX package's: the hand-rolled codec gives the same bytes, and the cases of
``tests/test_etcd3_integration.py`` run over genuine gRPC with each
package's client against each package's ``Etcd3Server``."""

import json
import time

import pytest

from caltech_bifrost_dsp_tpu.control import command as jcommand
from caltech_bifrost_dsp_tpu.control import etcd3_wire as jwire
from caltech_bifrost_dsp_tpu_torch.control import command, etcd3_wire
from caltech_bifrost_dsp_tpu_torch.control.store import Etcd3Store, connect
from caltech_bifrost_dsp_tpu_torch.utils import proclog

pytest.importorskip("grpc")

#: (server, client) of each combination
PAIRS = {"port": (etcd3_wire.Etcd3Server, etcd3_wire.Etcd3Client),
         "jax_server": (jwire.Etcd3Server, etcd3_wire.Etcd3Client),
         "jax_client": (etcd3_wire.Etcd3Server, jwire.Etcd3Client)}


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    command.CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


@pytest.fixture(params=list(PAIRS))
def wire(request):
    server_cls, client_cls = PAIRS[request.param]
    svr = server_cls("127.0.0.1", 0)
    try:
        yield request.param, svr.port, client_cls
    finally:
        svr.stop()


def test_proto_codec_matches_jax():
    """Nested messages, repeated fields, negative int64 and the prefix
    range_end convention: the port's encoder gives the JAX encoder's
    bytes and each decoder reads both."""
    inner = [(1, b"/cmd/corr"), (3, 42), (5, b"payload"), (4, 0), (6, None)]
    for enc, dec in ((etcd3_wire.enc_msg, jwire.dec_msg),
                     (jwire.enc_msg, etcd3_wire.dec_msg)):
        i = enc(*inner)
        outer = enc((1, i), (2, 7), (11, i), (11, i), (9, -1), (8, True))
        d = dec(outer)
        assert d[2] == [7] and len(d[11]) == 2 and d[8] == [1]
        assert d[9] == [(1 << 64) - 1]
        di = dec(d[1][0])
        assert di[1] == [b"/cmd/corr"] and di[3] == [42] and 4 not in di
    assert etcd3_wire.enc_msg((1, i), (2, 300)) == jwire.enc_msg((1, i),
                                                                 (2, 300))
    kv = etcd3_wire.enc_keyvalue(b"/k", b"v", 5, 3, 2)
    assert kv == jwire.enc_keyvalue(b"/k", b"v", 5, 3, 2)
    assert etcd3_wire.dec_keyvalue(kv) == jwire.dec_keyvalue(kv)
    for p in (b"/cmd", b"a\xff", b"\xff\xff", b"/mon/corr/"):
        assert etcd3_wire.prefix_range_end(p) == jwire.prefix_range_end(p)
    assert etcd3_wire.prefix_range_end(b"/cmd") == b"/cme"
    assert etcd3_wire.prefix_range_end(b"a\xff") == b"b"


def test_connect_gives_the_etcd_client():
    """An etcd host gives the wire client (which connects lazily, so no
    server is needed here)."""
    st = connect("127.0.0.1", 23799)
    assert isinstance(st, etcd3_wire.Etcd3Client)
    st.close()


def command_round_trip(block_cls, store):
    """tests/test_etcd3_integration.py::_command_round_trip."""
    blk = block_cls("Corr", store=store)
    blk.define_command_key("acc_len", type=int, initial_val=2400,
                           condition=lambda x: x % 240 == 0)

    def response(seq):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            raw = store.get(blk.response_key)
            if raw and str(json.loads(raw).get("id")) == seq:
                return json.loads(raw)
            time.sleep(0.02)
        raise AssertionError(f"no response to command {seq}")

    store.put(blk.command_key, json.dumps(
        {"id": "77", "cmd": "update", "val": {"kwargs": {"acc_len": 4800}}}))
    assert response("77")["val"]["status"] == "normal"
    assert blk.update_pending
    blk.update_command_vals()
    assert blk.command_vals["acc_len"] == 4800
    store.put(blk.command_key, json.dumps(
        {"id": "78", "cmd": "update", "val": {"kwargs": {"acc_len": 7}}}))
    assert response("78")["val"]["response"] != 0


def test_command_round_trip_over_wire_server(wire):
    """A command block of the client's package answers over gRPC."""
    pair, port, client_cls = wire
    store = client_cls("127.0.0.1", port)
    block_cls = (jcommand.CommandBlock if pair == "jax_client"
                 else command.CommandBlock)
    try:
        command_round_trip(block_cls, store)
    finally:
        store.close()


def test_kv_and_prefix_watch_over_wire_server(wire):
    _, port, client_cls = wire
    store = client_cls("127.0.0.1", port)
    other = Etcd3Store("127.0.0.1", port)
    try:
        store.put("/mon/a", "1")
        store.put("/mon/b", "2")
        other.put("/other", "3")
        assert other.get("/mon/a") == "1"
        assert store.get("/missing") is None
        assert store.get_prefix("/mon/") == {"/mon/a": "1", "/mon/b": "2"}
        store.delete("/mon/a")
        assert other.get("/mon/a") is None
        got = []
        wid = store.add_watch_prefix_callback(
            "/mon/", lambda wr: got.extend((e.key, e.value)
                                           for e in wr.events))
        other.put("/mon/c", "9")
        other.put("/nope", "0")
        other.put("/mon/d", "10")
        deadline = time.monotonic() + 10
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        store.cancel_watch(wid)
        assert got == [("/mon/c", "9"), ("/mon/d", "10")]
    finally:
        store.close()
        other.close()


def test_port_client_commands_a_block_on_the_jax_server():
    """The operator client of the port commands a JAX command block, both
    on the JAX package's etcd-protocol server."""
    from caltech_bifrost_dsp_tpu_torch.control.client import \
        CorrControlClient

    svr = jwire.Etcd3Server("127.0.0.1", 0)
    bstore = jwire.Etcd3Client("127.0.0.1", svr.port)
    cstore = connect("127.0.0.1", svr.port)
    try:
        blk = jcommand.CommandBlock("Corr", store=bstore, host="ehost")
        blk.define_command_key("acc_len", type=int, initial_val=2400)
        cli = CorrControlClient(store=cstore, timeout_s=10.0)
        assert cli.send_command("ehost", 0, "Corr", blk.instance_id,
                                acc_len=4800)["status"] == "normal"
        blk.update_command_vals()
        assert blk.command_vals["acc_len"] == 4800
        blk.close()
    finally:
        cstore.close()
        bstore.close()
        svr.stop()
