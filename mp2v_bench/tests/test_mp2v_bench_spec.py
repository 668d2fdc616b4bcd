"""``BENCHMARK.json`` against the benchmark's contract (names, units,
keys, limits), and the cells, configurations, traffic mixes and metric
readers found by name: one added as new files and entries is found with no
file that is there edited."""
import hashlib
import json
import os
import re
import shutil

import pytest

from mp2v_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# keys of a configuration's file that say what it is, not how it is run
META = {"name", "source", "deployment", "guarantee", "reduced", "assumed"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape(bench):
    assert set(bench) == KEYS["top"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p.split("/")
               for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(map(_line, bench["command"]))
    for kind in ("config", "workload", "end_to_end", "per_layer"):
        key = kind + "s" if kind in ("config", "workload") else kind
        for entry in bench[key]:
            extra = set(entry) - KEYS[kind]
            assert not extra - {"workloads"} or kind not in (
                "end_to_end", "per_layer"), (entry["name"], extra)
            if kind in ("config", "workload"):
                assert set(entry) == KEYS[kind], entry["name"]
            else:
                assert KEYS[kind] <= set(entry), entry["name"]


def test_names_and_units(bench):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for key in ("configs", "workloads"):
        got = [n for k, n in names if k == key]
        assert len(got) == len(set(got))
    metrics = [n for k, n in names if k in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for c in bench["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["per_layer"]:
        assert _line(m["layer"])


def test_references(bench):
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {w["config"] for w in bench["workloads"]} == configs
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert any(m["name"] == "setup_s" and "workloads" not in m
               and m["bound"] <= 0.25 for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for name in cells:
        cell = spec.cell(name, bench)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_files_and_reduced(bench):
    root = spec.ROOT
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        config = spec.load_json(os.path.join(root, c["file"]))
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert set(config["reduced"]) == set(c["reduced"])
        assert not set(c["reduced"]) & META
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_added_files_are_found(tmp_path, bench):
    """A new configuration, traffic mix, per-layer metric and cell, each
    as new files and new entries: found by name, no file that was there
    changed."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "mp2v_bench"),
                    root / "mp2v_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(root / "mp2v_bench")
    pkg = root / "mp2v_bench"
    config = spec.load_json(str(pkg / "configs" / "mp_hl_1080_420.json"))
    config.update(name="mp_ml_576_420", width=720, height=576)
    (pkg / "configs" / "mp_ml_576_420.json").write_text(json.dumps(config))
    (pkg / "traffic" / "offline_chunk4.json").write_text(json.dumps(
        {"loop": "closed", "mc_impl": "mxu", "decoder": {"gop_chunk": 4},
         "repeat": 4, "warmup": 1, "sample_decodes": 2}))
    (pkg / "metrics" / "output_ms_per_frame.py").write_text(
        "def read(w):\n    return w.stats['output_s'] / w.frames * 1e3\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "mp_ml_576_420", "source": "x",
                           "file": "mp2v_bench/configs/mp_ml_576_420.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "sd576_chunk4",
                             "config": "mp_ml_576_420",
                             "traffic": "offline_chunk4", "chips": 1,
                             "why": "x"})
    for m in new["end_to_end"]:
        if m["name"] == "kernel_us_per_frame":
            m["workloads"].append("sd576_chunk4")
    new["per_layer"].append({"name": "output_ms_per_frame.tput",
                             "unit": "ms/frame", "better": "lower",
                             "source": "program_counter", "layer": "delivery",
                             "moves": "kernel_us_per_frame",
                             "workloads": ["sd576_chunk4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))

    cell = spec.cell("sd576_chunk4", root=str(root))
    assert cell.config["width"] == 720
    assert cell.traffic["decoder"] == {"gop_chunk": 4}
    assert [m["name"] for m in cell.per_layer] == ["output_ms_per_frame.tput"]
    assert {m["name"] for m in cell.end_to_end} == {"kernel_us_per_frame",
                                                    "setup_s"}
    read = spec.reader("output_ms_per_frame.tput", root=str(root))
    from mp2v_bench.drive import Window
    assert read(Window(frames=4, stats={"output_s": 0.02})) == 5.0
    after = _digests(root / "mp2v_bench")
    assert {k: v for k, v in after.items() if k in before} == before
