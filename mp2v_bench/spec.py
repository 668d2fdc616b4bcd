"""What ``BENCHMARK.json`` names, found by name: the cells, their
configurations (``configs/<name>.json``), traffic mixes
(``traffic/<name>.json``), traffic loops (``loops/<name>.py``), stream
generators (``streams/<name>.py``) and metric readers
(``metrics/<name>.py``).  Nothing here names one of them.

A cell is added by new files and new entries alone, no file that is there
edited:

* a configuration: its file under ``configs/`` and its entry under
  ``configs`` in ``BENCHMARK.json``.  It may name a ``"generator"``, a
  module ``streams/<name>.py`` with ``make_stream(config, seed, pool)``
  and ``picture_types(config)`` (without the key, ``streams/generate.py``),
  and carry ``"channels"``: a list of objects, each laid over the
  configuration's keys for one channel (:func:`channels`); channel 0's
  stream comes from the run's seed, channel ``c``'s from
  :func:`channel_seed`;
* a traffic mix: its file under ``traffic/``, whose ``"loop"`` names a
  module ``loops/<name>.py`` with a class ``Loop`` (a ``drive.Runner``:
  its warm-up, its measured window and the comparison of what the window
  kept against the references); ``"spans": true`` has the decoder's spans
  recorded over the traced part of the window (``Window.spans``);
* a metric: its reader ``metrics/<name>.py`` (``read(window)``, which
  may read every numeric counter of the decoder's ``stats`` in
  ``Window.stats``, the spans and the trace) and its entry under
  ``end_to_end`` or ``per_layer``;
* the cell: its entry under ``workloads``, and its name appended to the
  ``workloads`` list of each end-to-end metric it reports (these lists,
  and a per-layer metric's, are the benchmark's schema).

An unknown loop or generator fails here, at :func:`cell`, with its name,
as an unknown metric fails at :func:`reader`.
"""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = os.path.basename(HERE)
# the generator of a configuration that names none
DEFAULT_GENERATOR = "generate"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names: its configuration,
    its traffic mix, the metrics it reports with and without a trace, in
    ``BENCHMARK.json``'s order, its loop's class and its generator's
    module, and the checkout they were found in."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    loop: type = None
    generator: object = None
    root: str = ROOT


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
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, PACKAGE, "traffic",
                                     entry["traffic"] + ".json"))
    return Cell(
        name=name, chips=entry["chips"], config=config, traffic=traffic,
        end_to_end=e2e, per_layer=per_layer,
        loop=loop(traffic["loop"], root), generator=generator(config, root),
        root=root)


def _load(kind: str, stem: str, root: str):
    """``<kind>/<stem>.py`` under the benchmark's package in ``root``,
    loaded from its file; ``None`` where there is no such file."""
    path = os.path.join(root, PACKAGE, kind, stem + ".py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}.{kind}.{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The ``read(window)`` function of a metric: ``metrics/<name>.py``,
    or for a name with a suffix (``tokenize_ms_per_frame.tput``) the
    reader of the name before its first dot."""
    for stem in (metric, metric.split(".")[0]):
        mod = _load("metrics", stem, root)
        if mod is not None:
            return mod.read
    raise KeyError(f"no reader for metric {metric!r} under metrics/")


def loop(name: str, root: str = ROOT) -> type:
    """The ``Loop`` class of a traffic loop, ``loops/<name>.py``."""
    mod = _load("loops", name, root)
    if mod is None:
        raise KeyError(f"no traffic loop {name!r} under loops/")
    return mod.Loop


def generator(config: dict, root: str = ROOT):
    """The stream generator a configuration names (``"generator"``,
    ``streams/<name>.py``; ``streams/generate.py`` without the key).  It
    is imported as a module of the package, not loaded from its file:
    its functions run on worker processes, which find them by name."""
    name = config.get("generator", DEFAULT_GENERATOR)
    if not os.path.exists(os.path.join(root, PACKAGE, "streams",
                                       name + ".py")):
        raise KeyError(f"no stream generator {name!r} under streams/")
    return importlib.import_module(f"{PACKAGE}.streams.{name}")


def channels(config: dict) -> list:
    """Each channel's configuration: the configuration's keys with one
    entry of its ``"channels"`` laid over them, or without the key the
    configuration itself, as one channel."""
    base = {k: v for k, v in config.items() if k != "channels"}
    return [{**base, **over} for over in config.get("channels", [{}])]


def channel_seed(seed: int, channel: int) -> int:
    """The seed of a channel's stream: the run's seed for channel 0, and
    for the others a 63-bit number drawn from the seed and the channel."""
    if channel == 0:
        return seed
    digest = hashlib.sha256(f"{seed}/{channel}".encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


def channel_streams(config: dict, seed: int, pool=None,
                    root: str = ROOT) -> list:
    """Every channel's stream of a configuration from the run's seed, made
    by the configuration's generator (on ``pool``'s workers, where
    given)."""
    gen = generator(config, root)
    return [gen.make_stream(c, channel_seed(seed, i), pool)
            for i, c in enumerate(channels(config))]
