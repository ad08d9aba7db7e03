"""Live dashboard over the monitor keys (port of
``caltech_bifrost_dsp_tpu/scripts/monitor.py``).

The reference's pipeline-control/scripts/etcd_monitor.py: a refresh loop
over :func:`..control.monitor.render_text` (any terminal, and logs), or
with ``--curses`` the full-screen view::

  python -m caltech_bifrost_dsp_tpu_torch.scripts.monitor \\
      --etcdhost kv://127.0.0.1:4440 --once
"""

from __future__ import annotations

import argparse
import sys
import time

from ..control.monitor import render_text
from ..control.store import connect


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="X-engine monitor (PyTorch + CUDA port)")
    p.add_argument("--etcdhost", type=str, default=None)
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--once", action="store_true")
    p.add_argument("--curses", action="store_true",
                   help="full-screen curses dashboard (the reference "
                        "etcd_monitor.py form)")
    args = p.parse_args(argv)
    store = connect(args.etcdhost)
    if args.curses:
        return run_curses(store, args.interval)
    while True:
        txt = render_text(store)
        if not args.once:
            sys.stdout.write("\x1b[2J\x1b[H")
        print(time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime()))
        print(txt or "(no monitor keys yet)")
        if args.once:
            return 0
        time.sleep(args.interval)


def run_curses(store, interval: float) -> int:
    """Full-screen dashboard (reference: etcd_monitor.py); q quits."""
    import curses

    def loop(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        while True:
            scr.erase()
            header = time.strftime("%Y-%m-%d %H:%M:%S UTC  (q quits)",
                                   time.gmtime())
            try:
                scr.addstr(0, 0, header, curses.A_BOLD)
                lines = (render_text(store)
                         or "(no monitor keys yet)").split("\n")
                maxy, maxx = scr.getmaxyx()
                for i, line in enumerate(lines[:maxy - 2]):
                    scr.addstr(i + 2, 0, line[:maxx - 1])
            except curses.error:
                pass  # terminal smaller than the content
            scr.refresh()
            t0 = time.monotonic()
            while time.monotonic() - t0 < interval:
                if scr.getch() in (ord("q"), ord("Q")):
                    return 0
                time.sleep(0.05)

    return curses.wrapper(loop)


if __name__ == "__main__":
    sys.exit(main())
