"""The port's bundled TCP store (``control/netstore.py``) against the JAX
package's: the cases of ``tests/test_netstore.py`` on the port, the same
bytes on the wire, and each package's client against the other's server,
commands included."""

import json
import socket
import time

import pytest

from caltech_bifrost_dsp_tpu.control import client as jclient
from caltech_bifrost_dsp_tpu.control import command as jcommand
from caltech_bifrost_dsp_tpu.control import netstore as jnet
from caltech_bifrost_dsp_tpu_torch.control import client, command, netstore
from caltech_bifrost_dsp_tpu_torch.control.store import connect
from caltech_bifrost_dsp_tpu_torch.utils import proclog

PAIRS = {"port": (netstore.StoreServer, netstore.NetStore),
         "jax_server": (jnet.StoreServer, netstore.NetStore),
         "jax_client": (netstore.StoreServer, jnet.NetStore)}


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    command.CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


def wait_for(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("pair", list(PAIRS))
def test_kv_roundtrip_and_prefix(pair):
    server_cls, client_cls = PAIRS[pair]
    srv = server_cls(port=0)
    cli = client_cls(port=srv.port)
    try:
        cli.put("/a/b", "1")
        cli.put("/a/c", "2")
        cli.put("/x", "3")
        assert cli.get("/a/b") == "1"
        assert cli.get("/missing") is None
        assert cli.get_prefix("/a") == {"/a/b": "1", "/a/c": "2"}
        cli.delete("/a/b")
        assert cli.get("/a/b") is None
    finally:
        cli.close()
        srv.close()


@pytest.mark.parametrize("pair", list(PAIRS))
def test_watch_callbacks_across_clients(pair):
    server_cls, client_cls = PAIRS[pair]
    srv = server_cls(port=0)
    a = client_cls(port=srv.port)
    b = netstore.NetStore(port=srv.port)
    got = []
    try:
        wid = a.add_watch_prefix_callback("/cmd", lambda wr: got.extend(
            (e.key, e.value) for e in wr.events))
        b.put("/cmd/x", "hello")
        b.put("/other", "nope")
        b.put("/cmd/y", "world")
        assert wait_for(lambda: len(got) >= 2)
        assert got == [("/cmd/x", "hello"), ("/cmd/y", "world")]
        a.cancel_watch(wid)
    finally:
        a.close()
        b.close()
        srv.close()


def test_wire_bytes_equal_jax():
    """The same requests on a raw socket get the same reply lines from
    both servers."""
    reqs = [{"op": "put", "key": "/k", "value": "v"},
            {"op": "get", "key": "/k"},
            {"op": "get", "key": "/none"},
            {"op": "get_prefix", "prefix": "/"},
            {"op": "delete", "key": "/k"},
            {"op": "bogus"}]
    replies = []
    for cls in (jnet.StoreServer, netstore.StoreServer):
        srv = cls(port=0)
        sock = socket.create_connection(("127.0.0.1", srv.port), 5.0)
        fh = sock.makefile("rwb")
        lines = []
        for r in reqs:
            fh.write((json.dumps(r) + "\n").encode())
            fh.flush()
            lines.append(fh.readline())
        watch = socket.create_connection(("127.0.0.1", srv.port), 5.0)
        wfh = watch.makefile("rwb")
        wfh.write(b'{"op": "watch", "prefix": "/w"}\n')
        wfh.flush()
        lines.append(wfh.readline())
        fh.write(b'{"op": "put", "key": "/w/1", "value": "x"}\n')
        fh.flush()
        lines.append(fh.readline())
        lines.append(wfh.readline())
        sock.close()
        watch.close()
        srv.close()
        replies.append(lines)
    assert replies[1] == replies[0]
    assert replies[0][-1] == b'{"event": {"key": "/w/1", "value": "x"}}\n'


@pytest.mark.parametrize("pair", ["port", "port_block_jax_client",
                                  "jax_block_port_client"])
def test_command_block_over_network_store(pair):
    """tests/test_netstore.py::test_command_block_over_network_store: the
    block and the client talk only through the TCP store; a block of one
    package answers the client of the other."""
    srv = netstore.StoreServer(port=0)
    block_store = netstore.NetStore(port=srv.port)
    client_store = connect(f"kv://127.0.0.1:{srv.port}")
    assert isinstance(client_store, netstore.NetStore)
    block_cls = (jcommand.CommandBlock if pair == "jax_block_port_client"
                 else command.CommandBlock)
    cli_cls = (jclient.CorrControlClient if pair == "port_block_jax_client"
               else client.CorrControlClient)
    blk = block_cls("Corr", store=block_store, host="nethost")
    blk.define_command_key("acc_len", type=int, initial_val=2400,
                           condition=lambda x: x % 480 == 0)
    cli = cli_cls(store=client_store, timeout_s=5.0)
    try:
        resp = cli.send_command("nethost", 0, "Corr", blk.instance_id,
                                acc_len=4800)
        assert resp["status"] == "normal"
        blk.update_command_vals()
        assert blk.command_vals["acc_len"] == 4800
        with pytest.raises(RuntimeError, match="rejected"):
            cli.send_command("nethost", 0, "Corr", blk.instance_id,
                             acc_len=7)
    finally:
        blk.close()
        block_store.close()
        client_store.close()
        srv.close()


def test_dead_watcher_is_pruned():
    """A watcher whose connection is gone is dropped at a later put, and
    puts to its prefix go on succeeding."""
    srv = netstore.StoreServer(port=0)
    b = netstore.NetStore(port=srv.port)
    watch = socket.create_connection(("127.0.0.1", srv.port), 5.0)
    try:
        wfh = watch.makefile("rwb")
        wfh.write(b'{"op": "watch", "prefix": "/p"}\n')
        wfh.flush()
        assert wfh.readline() == b'{"ok": true}\n'
        assert len(srv.hub.watchers) == 1
        wfh.close()
        watch.close()
        n = iter(range(10 ** 6))
        assert wait_for(lambda: (b.put(f"/p/{next(n)}", "1"),
                                 len(srv.hub.watchers) == 0)[1])
        b.put("/p/y", "2")
        assert b.get("/p/y") == "2"
    finally:
        b.close()
        srv.close()
