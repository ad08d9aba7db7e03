"""Per-server pipeline manager daemon (port of
``caltech_bifrost_dsp_tpu/scripts/xeng_manager.py``).

The reference's pipeline-control/scripts/lwa352_start_xeng_etcd_service.py
with lwa352_xeng_etcd_client.py: the RPC service that starts and stops the
port's pipeline processes (``caltech_bifrost_dsp_tpu_torch.scripts.
pipeline``) on this host.  ``--serve-kv PORT`` also runs the bundled TCP
store, ``--serve-etcd PORT`` the bundled etcd-protocol server (needs
``grpc``)::

  python -m caltech_bifrost_dsp_tpu_torch.scripts.xeng_manager \\
      --serve-kv 4440 --pidfile-dir /tmp/xeng
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..control.manager import XengineController, XengineManagerService
from ..control.store import connect


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="X-engine host manager (PyTorch + CUDA port)")
    p.add_argument("--etcdhost", type=str, default=None)
    p.add_argument("--pidfile-dir", type=str, default="/tmp")
    p.add_argument("--cores", type=str, default="",
                   help="pipeline_id:core,core;pipeline_id:... pinning")
    p.add_argument("--serve-kv", type=int, default=0, metavar="PORT",
                   help="also run the bundled TCP KV store on PORT "
                        "(etcd-less single-host control plane)")
    p.add_argument("--serve-etcd", type=int, default=0, metavar="PORT",
                   help="also run the bundled etcd-protocol gRPC server "
                        "on PORT (control/etcd3_wire.Etcd3Server): the "
                        "control plane then speaks the genuine etcd v3 "
                        "wire format, usable by stock etcd clients, "
                        "without an etcd binary")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    kv_server = None
    if args.serve_kv:
        from ..control.netstore import StoreServer

        kv_server = StoreServer("0.0.0.0", args.serve_kv)
        if not args.etcdhost:
            args.etcdhost = f"kv://127.0.0.1:{args.serve_kv}"
        print(f"KV store serving on :{kv_server.port}")
    etcd_server = None
    etcd_port = 2379
    if args.serve_etcd:
        from ..control.etcd3_wire import Etcd3Server

        etcd_server = Etcd3Server("0.0.0.0", args.serve_etcd)
        if not args.etcdhost:
            args.etcdhost = "127.0.0.1"
            etcd_port = etcd_server.port
        print(f"etcd-protocol server on :{etcd_server.port}")

    cpu_tables = {}
    if args.cores:
        for part in args.cores.split(";"):
            pid, _, cores = part.partition(":")
            cpu_tables[int(pid)] = [int(c) for c in cores.split(",")]

    store = connect(args.etcdhost, etcd_port)
    ctl = XengineController(pidfile_dir=args.pidfile_dir,
                            cpu_tables=cpu_tables)
    svc = XengineManagerService(store, ctl)
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    main.stop = stop  # embedders (tests) can stop a threaded main()
    print("manager listening on", svc.cmd_key)
    stop.wait()
    svc.close()
    ctl.kill_pipelines()
    if etcd_server is not None:
        etcd_server.stop()
    if kv_server is not None:
        kv_server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
