"""What ``BENCHMARK.json`` names, found by name: the cells, their
configurations (``configs/<name>.json``), traffic mixes
(``traffic/<name>.json``) and metric readers (``metrics/<name>.py``).

A cell, a configuration, a traffic mix or a metric is added by adding its
file and its entry; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = os.path.basename(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names: its configuration,
    its traffic mix, and the metrics it reports with and without a trace,
    in ``BENCHMARK.json``'s order."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or without
    a list every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def cell(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    bench = benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(
        name=name, chips=entry["chips"],
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(root, PACKAGE, "traffic",
                                       entry["traffic"] + ".json")),
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, root: str = ROOT):
    """The ``read(window)`` function of a metric: ``metrics/<name>.py``,
    or for a name with a suffix (``tokenize_ms_per_frame.tput``) the
    reader of the name before its first dot."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(root, PACKAGE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"mp2v_bench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for metric {metric!r} under metrics/")
