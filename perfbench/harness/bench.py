"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic mix; everything else is a file of its own under
``perfbench/``:

* ``configs/<config>.json``: the model as run (its ``port`` group) and its
  published source;
* ``traffic/<mix>.json``: the mix's parameters, read by ``traffic.py``;
* ``limits/<cell>.json``: the limits of the numbers ``check.py`` compares,
  and the readings they were set from;
* ``metrics/<metric>.py``: one reader per metric, ``read(record)``
  returning a number or None (nothing to read: the metric is left out).
  A metric named ``<stem>.<mix>`` with no file of its own is read by
  ``metrics/<stem>.py``: one reader serves the quantity in every mix.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its BENCHMARK.json entry, configuration, mix,
    limits, and the metrics it reports (end-to-end and per-layer)."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return {
        "entry": entry,
        "config": load_json(root / config["file"]),
        "mix": load_json(PERFBENCH / "traffic" / f"{entry['traffic']}.json"),
        "limits": load_json(PERFBENCH / "limits" / f"{name}.json"),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "run_seconds": bench["run_seconds"],
    }


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, or else ``metrics/<stem>.py`` for a metric
    named ``<stem>.<mix>``."""
    path = PERFBENCH / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = PERFBENCH / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    return path


def reader(metric: str):
    """``read`` of the metric's reader (``reader_path``)."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
