"""A cell is added by new files and entries alone: traffic loops and
stream generators found by name, a configuration of several channels, and
every numeric counter of the decoder in the window.  Each case builds a
small benchmark tree under ``tmp_path`` (``spec`` takes its ``root``) and
runs on the CPU."""
import json
import os
import re
import shutil
import time
from collections import Counter

import pytest

from mp2v_bench import reference, roofline, spec
from mp2v_bench.loops import closed, open as open_loop
from mp2v_bench.run import run_cell
from mp2v_bench.streams import generate

CONFIGS = ("mp_hl_1080_420", "422p_hl_1080_422")
TRAFFIC = ("offline_stream", "live_paced")
SMALL = {"width": 64, "height": 40}
# the decoder's counters the existing readers read
STATS = ("pictures", "tokenize_s", "fill_s", "device_s", "output_s")
SEED = 2**31 + 77
FRAMES = 4

# A loop over several channels, as a later cell would add it: each
# channel's stream decoded in turn, closed loop; with "fault_channel" in
# the traffic, one byte of each frame of that channel altered where it is
# produced.
CHANNEL_LOOP = '''
import time

from mp2v_bench import check
from mp2v_bench.drive import Reservoir, Runner, add_stats


class Altered:
    def __init__(self, frame):
        self.frame = frame

    def device_buffer(self):
        buf = self.frame.device_buffer().clone().reshape(-1)
        buf[7] ^= 1
        return buf


class Loop(Runner):
    SAMPLED = "channel decodes"

    def prepare(self):
        self.kept = Reservoir(self.traffic["sample_decodes"], self.seed)
        self.fault = self.traffic.get("fault_channel")

    def _decode(self, c):
        self.dec.reset()
        frames = self.dec.decode(self.streams[c])
        self.sync()
        return [Altered(f) for f in frames] if c == self.fault else frames

    def warm_up(self):
        for _ in range(self.traffic["warmup"]):
            for c in range(len(self.streams)):
                self._decode(c)

    def window(self, w, seconds):
        t0 = time.perf_counter()
        w.start_ns = time.time_ns()
        while True:
            for c, config in enumerate(self.configs):
                frames = self._decode(c)
                add_stats(w.stats, self.dec.stats)
                self.kept.offer((c, frames))
                w.frames += len(frames)
                for i in range(config["distinct_pictures"]):
                    w.decoded[c, i] += 1
            done = self._elapsed(t0) >= seconds
            self._trace_point(w, t0, done)
            if done:
                break
        w.seconds = self._elapsed(t0)

    def compare(self, refs, device):
        import torch
        comp = check.Comparison(*(torch.from_numpy(r.display()).to(device)
                                  for r in refs))
        for _, (c, frames) in sorted(self.kept.kept.items()):
            comp.frames_against(frames, list(range(len(refs[c].pcts))), c)
        return comp
'''


def small(name):
    config = spec.load_json(f"{spec.ROOT}/mp2v_bench/configs/{name}.json")
    config.update(SMALL)
    return config


class Tree:
    """A copy of the benchmark's files under ``tmp_path``, to which a test
    adds files and entries."""

    def __init__(self, tmp_path):
        self.root = str(tmp_path / "checkout")
        shutil.copytree(os.path.join(spec.ROOT, "mp2v_bench"),
                        os.path.join(self.root, "mp2v_bench"),
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        self.bench = spec.benchmark()

    def add(self, kind, name, body):
        """``mp2v_bench/<kind>/<name>``: a dict as JSON, or source text."""
        path = os.path.join(self.root, "mp2v_bench", kind, name)
        with open(path, "w") as f:
            f.write(body if isinstance(body, str) else json.dumps(body))

    def add_cell(self, name, config, traffic, metrics=("frames_per_s",)):
        """A workload on ``config`` (a dict, added as a configuration of
        its own ``name``) and ``traffic`` (a name), reported under the
        end-to-end ``metrics``; one the benchmark lacks is added as an
        entry of its own (its reader is ``metrics/<name>.py``)."""
        self.add("configs", config["name"] + ".json", config)
        self.bench["configs"].append({
            "name": config["name"], "source": "x", "reduced": [], "why": "x",
            "file": f"mp2v_bench/configs/{config['name']}.json"})
        self.bench["workloads"].append({"name": name,
                                        "config": config["name"],
                                        "traffic": traffic, "chips": 1,
                                        "why": "x"})
        known = {m["name"]: m for m in self.bench["end_to_end"]}
        for metric in metrics:
            if metric not in known:
                known[metric] = {"name": metric, "unit": "x",
                                 "better": "higher", "bound": 0.25,
                                 "source": "host_clock", "workloads": []}
                self.bench["end_to_end"].append(known[metric])
            known[metric]["workloads"].append(name)
        self.save()

    def save(self):
        with open(os.path.join(self.root, "BENCHMARK.json"), "w") as f:
            json.dump(self.bench, f)

    def cell(self, name):
        return spec.cell(name, root=self.root)


@pytest.fixture
def tree(tmp_path):
    return Tree(tmp_path)


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("name", CONFIGS)
def test_one_channel_is_the_generators_stream(name, seed):
    config = small(name)
    assert spec.channels(config) == [config]
    assert spec.channel_seed(seed, 0) == seed
    assert spec.generator(config) is generate
    assert spec.channel_streams(config, seed) == [
        generate.make_stream(config, seed)]


class Clock:
    """A host clock that moves only as the code reads it or sleeps, so a
    window runs the same decodes and pictures every time."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-4
        return self.t

    def sleep(self, s):
        self.t += s


class FakeDecoder:
    """A decoder whose counters grow by fixed amounts a picture, with a
    counter the existing readers do not read and a key that is no
    number."""

    def __init__(self, config, clock):
        self.clock = clock
        self.renderer = None
        self.stats = {}
        self.reset()

    def reset(self):
        self.stats = {"pictures": 0, "tokenize_s": 0.0, "fill_s": 0.0,
                      "device_s": 0.0, "output_s": 0.0, "chunk_wait_s": 0.0,
                      "mode": "fake"}

    def decode(self, data):
        self.clock.sleep(0.01)
        s = self.stats
        s["pictures"] += FRAMES
        for k, per in (("tokenize_s", 1e-3), ("fill_s", 2e-3),
                       ("device_s", 3e-3), ("output_s", 4e-3),
                       ("chunk_wait_s", 5e-3)):
            s[k] += per * FRAMES
        return [object()] * FRAMES


def fake_window(loop_cls, loop, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(time, "sleep", clock.sleep)
    config = {"distinct_pictures": FRAMES, "frame_rate": [100, 1]}
    traffic = {"loop": loop, "mc_impl": "mxu", "decoder": {}, "repeat": 2,
               "sample_decodes": 2, "sample_pictures": 2, "warmup": 1}
    data = (generate.GROUP_START + b"\x00\x00\x01\x00\x11" * FRAMES
            + generate.SEQUENCE_END)
    runner = loop_cls([config], traffic, [data], 5, "cpu",
                      lambda cfg: FakeDecoder(cfg, clock), lambda **kw: kw,
                      lambda: None)
    runner.warm_up()
    return runner.run(0.5)


@pytest.mark.parametrize("loop, module", (("closed", closed),
                                          ("open", open_loop)))
def test_loop_found_by_name_is_the_direct_call(loop, module, tree,
                                               monkeypatch):
    found = fake_window(spec.loop(loop, tree.root), loop, monkeypatch)
    direct = fake_window(module.Loop, loop, monkeypatch)
    assert found.frames == direct.frames > 0
    assert found.decoded == direct.decoded
    assert sum(found.decoded.values()) > 0
    assert {k: found.stats[k] for k in STATS} == {
        k: direct.stats[k] for k in STATS}
    # every numeric counter is in the window, the rest is not
    assert found.stats["chunk_wait_s"] == direct.stats["chunk_wait_s"] > 0
    assert "mode" not in found.stats
    # summed over the decodes (closed) or grown over the window (open):
    # either way, the pictures' share of each counter
    pictures = found.stats["pictures"]
    assert found.stats["fill_s"] == pytest.approx(2e-3 * pictures)


@pytest.mark.parametrize("loop", ("closed", "open"))
def test_one_channel_loops_refuse_several(loop):
    config = {"distinct_pictures": FRAMES, "frame_rate": [100, 1]}
    traffic = {"loop": loop, "mc_impl": "mxu", "decoder": {}, "repeat": 1,
               "sample_decodes": 1, "sample_pictures": 1}
    with pytest.raises(ValueError, match="drives one channel"):
        spec.loop(loop)([config, config], traffic, [b"", b""], 0, "cpu",
                        lambda cfg: FakeDecoder(cfg, Clock()),
                        lambda **kw: kw, lambda: None)


def two_channels():
    config = small("mp_hl_1080_420")
    config.update(name="two_channels", channels=[
        {"distinct_pictures": 7},
        {"first_picture": "I", "cycle": "PB", "distinct_pictures": 9}])
    return config


def channel_cell(tree, fault):
    traffic = {"loop": "channels_closed", "mc_impl": "mxu",
               "decoder": {"gop_chunk": 16, "output_host": False,
                           "pictures_pool_size": 0, "num_threads": 4},
               "warmup": 1, "sample_decodes": 4}
    if fault is not None:
        traffic["fault_channel"] = fault
    tree.add("loops", "channels_closed.py", CHANNEL_LOOP)
    tree.add("traffic", "channels.json", traffic)
    tree.add_cell("two_channels_offline", two_channels(), "channels")
    return tree.cell("two_channels_offline")


def test_two_channels_two_streams():
    config = two_channels()
    configs = spec.channels(config)
    assert [c["distinct_pictures"] for c in configs] == [7, 9]
    assert [c["cycle"] for c in configs] == ["PBB", "PB"]
    assert all("channels" not in c for c in configs)
    streams = spec.channel_streams(config, SEED)
    assert streams[0] == generate.make_stream(configs[0], SEED)
    assert streams[1] == generate.make_stream(
        configs[1], spec.channel_seed(SEED, 1))
    assert streams[0] != streams[1]
    assert spec.channel_seed(SEED, 1) not in (SEED, spec.channel_seed(
        SEED + 1, 1), spec.channel_seed(SEED, 2))
    assert [len(generate.picture_units(s)) for s in streams] == [7, 9]


@pytest.mark.parametrize("fault", (None, 1))
def test_a_channel_loop_added_as_files(fault, tree, capsys):
    cell = channel_cell(tree, fault)
    assert cell.loop.__module__ == "mp2v_bench.loops.channels_closed"
    r = run_cell(cell, SEED, 1.0, False, device="cpu",
                 t_start=time.perf_counter())
    by_channel = re.search(r"mismatched bytes by channel: 0: (\d+), 1: (\d+)",
                           capsys.readouterr().err)
    assert by_channel is not None
    first, second = map(int, by_channel.groups())
    assert r["attempted"] > 0 and set(r["metrics"]) == {"frames_per_s",
                                                        "setup_s"}
    assert first == 0
    if fault is None:
        assert r["correct"] and r["failed"] == 0 and second == 0
    else:
        assert not r["correct"] and r["failed"] > 0
        assert second == r["checks"]["mismatched_bytes"]["value"] > 0


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_a_new_counter_is_read_by_a_new_metric_file(traffic, tree):
    from tiny_mp2v_dec_tpu_torch.runtime.decoder import (DecoderConfig,
                                                          MP2VDecoder)
    tree.add("metrics", "chunk_wait_ms_per_frame.py",
             "def read(w):\n"
             "    if not w.frames:\n"
             "        return None\n"
             "    return w.stats['chunk_wait_s'] / w.frames * 1e3\n")
    tree.add_cell("counter_cell", small("mp_hl_1080_420") | {
        "name": "counter_config"}, traffic,
        ("frames_per_s", "latency_p95_ms"))
    cell = tree.cell("counter_cell")
    streams = spec.channel_streams(cell.config, SEED, root=tree.root)
    runner = cell.loop(spec.channels(cell.config), cell.traffic, streams,
                       SEED, "cpu", MP2VDecoder, DecoderConfig, lambda: None)
    w = runner.run(0.5)
    value = spec.reader("chunk_wait_ms_per_frame.tput", tree.root)(w)
    assert isinstance(value, float) and value >= 0
    assert set(STATS) <= set(w.stats)
    assert w.stats["pictures"] > 0


class FakeProfiler:
    def start(self):
        pass

    def stop(self):
        return []


@pytest.mark.parametrize("spans", (False, True))
@pytest.mark.parametrize("traffic", TRAFFIC)
def test_spans_over_the_traced_part(traffic, spans):
    from tiny_mp2v_dec_tpu_torch.runtime.decoder import (DecoderConfig,
                                                          MP2VDecoder)
    cell = spec.cell("hd420_offline" if traffic == TRAFFIC[0]
                     else "hd420_live")
    cell.config.update(SMALL)
    if spans:
        cell.traffic["spans"] = True
    streams = spec.channel_streams(cell.config, SEED)
    runner = cell.loop(spec.channels(cell.config), cell.traffic, streams,
                       SEED, "cpu", MP2VDecoder, DecoderConfig, lambda: None)
    w = runner.run(0.6, FakeProfiler(), trace_s=0.2)
    if not spans:
        assert w.spans is None
        return
    assert w.spans and all(len(r) == 6 for r in w.spans)
    assert {r[0] for r in w.spans} >= {"decode", "tokenize", "dispatch"}
    assert max(r[4] for r in w.spans) <= w.trace_end_ns
    # recording stopped with the traced part
    assert runner.dec.spans.log is None


@pytest.mark.parametrize("name", CONFIGS)
def test_window_bytes_of_one_channel(name):
    data = generate.make_stream(small(name), SEED)
    ref = reference.decode(data, 2)
    counts = {i: 1 + i % 3 for i in range(len(ref.pcts))}
    decoded = Counter({(0, i): n for i, n in counts.items()})
    before = sum(n * roofline.picture_bytes(ref.tokens[i], ref.pcts[i])
                 for i, n in counts.items())
    assert roofline.window_bytes(decoded, [ref]) == before > 0


@pytest.mark.parametrize("kind", ("loop", "generator"))
def test_unknown_name_fails_at_cell(kind, tree):
    config = small("mp_hl_1080_420") | {"name": "named_config"}
    traffic = "offline_stream"
    if kind == "loop":
        tree.add("traffic", "no_loop.json", {"loop": "no_such_loop"})
        traffic = "no_loop"
    else:
        config["generator"] = "no_such_generator"
    tree.add_cell("named_cell", config, traffic)
    with pytest.raises(KeyError, match=f"no_such_{kind}"):
        tree.cell("named_cell")
