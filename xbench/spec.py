"""Find a cell's pieces by name.

- ``xbench/workloads/<cell>.json``: the cell (its configuration, traffic
  mix, chips, ``why``, the end-to-end and per-layer metrics it reports,
  and the limit of each number its comparison gives);
- ``xbench/configs/<config>.json``: one deployment (the X-engine's sizes,
  the sinks' limits, the inputs' statistics, the comparison's control,
  and ``pipelines_per_card``: 1, or 2 for the production layout of two
  pipeline processes on one card, run by :mod:`xbench.pair`);
- ``xbench/traffic/<traffic>.json``: one traffic mix, read by
  :mod:`xbench.traffic.pool`, naming its sinks;
- ``xbench/sinks/<sink>.py``: one product sink (how the harness builds
  it, and how its packets are decoded and judged);
- ``xbench/metrics/<metric>.py``: one per-layer metric (its unit, layer,
  the end-to-end metric it moves, and ``read``).

A later change adds a file of each kind and edits none.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: the end-to-end metrics a run takes (``xbench.cell.run_cell``)
END_TO_END = ("realtime_factor", "device_peak_gib", "setup_s")
#: the pipeline processes a configuration may run on its card
PIPELINES_PER_CARD = (1, 2)


def _load(kind: str, name: str) -> dict:
    if not NAME.match(name) or ".." in name:
        raise ValueError(f"bad {kind} name {name!r}")
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path.name})")
    return json.loads(path.read_text())


def workload(name: str) -> dict:
    return _load("workloads", name)


def config(name: str) -> dict:
    return _load("configs", name)


def traffic(name: str) -> dict:
    return _load("traffic", name)


def metric(name: str):
    """The module of per-layer metric ``name`` (``xbench.metrics.<name>``,
    a name with no dot)."""
    if not NAME.match(name) or "." in name or "-" in name:
        raise ValueError(f"bad metric name {name!r}")
    return importlib.import_module(f"xbench.metrics.{name}")


def names(kind: str) -> list[str]:
    """Every name of ``kind`` ("workloads", "configs", "traffic",
    "sinks", "metrics") present."""
    suffix = ".py" if kind in ("metrics", "sinks") else ".json"
    return sorted(p.stem for p in (ROOT / kind).glob(f"*{suffix}")
                  if p.stem != "__init__")


def pipelines_per_card(conf: dict) -> int:
    """The configuration's ``pipelines_per_card`` (1 where it gives
    none); refuses any value but the whole numbers 1 and 2."""
    n = conf.get("pipelines_per_card", 1)
    if type(n) is not int or n not in PIPELINES_PER_CARD:
        raise ValueError(f"configuration {conf.get('name')!r} gives "
                         f"pipelines_per_card {n!r}; the harness takes "
                         f"{' or '.join(map(str, PIPELINES_PER_CARD))}")
    return n


def betters() -> dict:
    """``better`` ("lower" or "higher") of each metric, by name, as the
    benchmark's ``BENCHMARK.json`` (beside ``xbench/``) gives it."""
    b = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    return {m["name"]: m["better"] for m in b["end_to_end"] + b["per_layer"]}


def cell(name: str) -> dict:
    """The workload ``name`` with its configuration, traffic, sink and
    metric modules resolved (:func:`resolve`)."""
    w = workload(name)
    return resolve(name, w, config(w["config"]), traffic(w["traffic"]))


def resolve(name: str, w: dict, conf: dict, traf: dict) -> dict:
    """Cell ``name`` of workload ``w``, configuration ``conf`` and traffic
    ``traf``, with its sink and metric modules.  Refuses a cell whose
    traffic names a sink with no module, that names an end-to-end metric
    the harness does not take or leaves out ``setup_s``, whose
    configuration gives another ``pipelines_per_card`` than 1 or 2, or
    that gives no limit for a number its comparison gives."""
    from . import sinks
    from .reference import check

    pipelines_per_card(conf)
    e2e = w["end_to_end"]
    if "setup_s" not in e2e or not set(e2e) <= set(END_TO_END):
        raise ValueError(f"cell {name!r} reports end-to-end {e2e}; the "
                         f"harness takes {', '.join(END_TO_END)}, and "
                         f"every cell setup_s")
    kinds = {}
    for s in traf.get("sinks", ()):
        try:
            kinds[s] = sinks.kind(s)
        except ModuleNotFoundError:
            raise ValueError(f"traffic {traf['name']!r} names sink {s!r}, "
                             f"which has no module") from None
    missing = [n for n in check.numbers(conf, traf, kinds)
               if n not in w["limits"]]
    if missing:
        raise ValueError(f"cell {name!r} gives no limit for "
                         f"{', '.join(missing)}")
    return {"name": name, "workload": w, "config": conf, "traffic": traf,
            "sinks": kinds, "metrics": [metric(m) for m in w["per_layer"]]}
