"""``BENCHMARK.json`` and the files it names, found by name:

- ``benchmark/configs/<config>.json``: the configuration as it is run
  (``sections``: the trainer's data, model, train, disentangle and loss
  sections), its ``source``, ``reduced`` and ``assumed``;
- ``benchmark/traffic/<traffic>.json``: the traffic mix (batch, stream
  length, ids), read by the one generator (``benchmark.synthetic``);
- ``benchmark/flops/<config>.b<batch>.json``: the pinned FLOP count of a step;
- ``benchmark/cells/<workload>.json``: the cell's window (``window_epochs``,
  the whole epochs a run of ``run_seconds`` trains) and the limits of the
  comparison that decides ``correct``, with the readings they were set
  from;
- ``benchmark/metrics/<metric>.py``: each metric's reader; a metric split
  by cell, ``<quantity>.<part>``, is read by ``<quantity>.py`` unless it
  has a reader of its own;
- ``benchmark/peaks.json``: the cards' peak rates.

A cell is added by adding such files and a ``workloads`` entry.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import pathlib
from typing import Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
SKELETON = HERE / "data" / "mouse_skeleton.yaml"


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(name: str, root: pathlib.Path = ROOT) -> dict:
    for w in benchmark(root)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def sections(config_name: str, batch: int, seed: Optional[int] = None) -> dict:
    """The configuration's trainer sections at ``batch`` (and ``train.seed``)."""
    out = copy.deepcopy(config(config_name)["sections"])
    out["data"]["batch_size"] = int(batch)
    if seed is not None:
        out["train"]["seed"] = int(seed)
    return out


def flops_file(config_name: str, batch: int) -> pathlib.Path:
    return HERE / "flops" / f"{config_name}.b{batch}.json"


def flops(config_name: str, batch: int) -> dict:
    return _json(flops_file(config_name, batch))


def cell(workload_name: str) -> dict:
    return _json(HERE / "cells" / f"{workload_name}.json")


def limits(workload_name: str) -> dict:
    return cell(workload_name)["limits"]


def reported(workload_name: str, trace: bool, root: pathlib.Path = ROOT) -> list:
    """The metrics a run of the cell reports: its end-to-end metrics (those
    whose ``workloads`` list it, or that have none) or, traced, the
    per-layer metrics that move one of them."""
    spec = benchmark(root)
    e2e = [m for m in spec["end_to_end"] if workload_name in m.get("workloads", [workload_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if m["moves"] in moved]


def peaks(kind: str) -> Optional[dict]:
    """The peak rates of the card called ``kind``, or None."""
    for card in _json(HERE / "peaks.json")["cards"]:
        if card["name"] in kind:
            return card
    return None


def metric_reader(name: str):
    """``read(run)`` of ``benchmark/metrics/<name>.py``, or of the
    quantity's reader for a metric split by cell."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
