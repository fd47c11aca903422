"""The harness on the CPU at a tiny size (``tiny.py``): the result line of
every cell, a cell and a metric added as new files only, the faults and
the control that ``correct`` has to catch, and BENCHMARK.json against the
limits of its format. Tests that need the card are marked ``cuda``."""

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.control import ControlServer, HalfIndexServer
from benchmark.program import ProgramServer
from benchmark.tests.tiny import ROOT, make_tiny_root

CPU = torch.device("cpu")
SEED = 2_147_483_659        # past 32 signed bits: seeds may be that large
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CHECKS = {"dist_err", "bad_answers", "recall_miss"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def run(bench, cell, trace=False, seconds=0.2, serve=None, seed=SEED):
    return harness.run_cell(bench, cell, seed, seconds, trace, CPU,
                            time.perf_counter(), serve=serve)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_prints_the_result_keys(tiny, cell, trace):
    out = run(tiny, cell, trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(json.loads(json.dumps(out))) == want
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == CHECKS
    section = "per_layer" if trace else "end_to_end"
    spec = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    names = {m["name"] for m in spec[section]
             if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) <= names
    if not trace:   # the CPU has no device metrics to read
        assert set(out["metrics"]) == names
        assert out["metrics"]["recall"]["value"] > 0.5
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_a_new_cell_and_metric_are_new_files_only(tiny):
    root = tiny.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (tiny / "traffic" / "wide-b16.json").write_text(json.dumps(
        {"batch": 16, "k": 5, "params": {"ef": 64}, "pool_requests": 2,
         "warmup_requests": 1, "trace_requests": 1,
         "checks": {"recall_miss": 0.2}}))
    (tiny / "metrics" / "p50_ms.py").write_text(
        "import numpy as np\n\n\ndef read(run):\n"
        "    return float(np.median(run.latencies_s)) * 1e3\n")
    spec["workloads"].append(
        {"name": "cohere768-1m.wide-b16", "config": "cohere768-1m",
         "traffic": "wide-b16", "chips": 1, "why": "a test cell"})
    spec["end_to_end"].append(
        {"name": "p50_ms", "unit": "ms", "better": "lower", "bound": 0.05,
         "source": "host_clock", "workloads": ["cohere768-1m.wide-b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        out = run(tiny, "cohere768-1m.wide-b16")
    finally:
        spec["workloads"].pop()
        spec["end_to_end"].pop()
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert out["correct"] is True
    assert out["metrics"]["p50_ms"]["value"] > 0
    assert "qps" in out["metrics"]


class Faulty:
    """The program with its timed path broken underneath."""

    def __init__(self, server, fault, rows):
        self.server, self.fault, self.rows, self.first = (
            server, fault, rows, None)

    def __call__(self, queries, k, params):
        d, ids = self.server(queries, k, params)
        d, ids = np.array(d), np.array(ids)
        if self.fault == "stale":        # returns its first state again
            if self.first is None:
                self.first = (d, ids)
            return self.first
        if self.fault == "half_batch":   # half of the batch left out
            h = len(ids) // 2
            d[h:], ids[h:] = np.inf, -1
        elif self.fault == "altered":    # an answer altered where produced
            ids[0, 0] = (ids[0, 0] + 1) % self.rows
        return d, ids

    def release(self):
        pass


@pytest.fixture(scope="module")
def servers(tiny):
    """One program server a cell, built once for the fault runs."""
    made = {}

    def get(cell):
        if cell not in made:
            c = harness.load_cell(tiny, cell)
            corpus, _, _ = harness.make_requests(c, SEED, CPU)
            made[cell] = (ProgramServer(c.config_path, corpus, CPU,
                                        lambda *a: None), len(corpus))
        return made[cell]
    yield get
    for server, _ in made.values():
        server.release()


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered",
                                   "half_index"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_come_out_not_correct(tiny, servers, cell, fault):
    if fault == "half_index":   # half of the corpus left out of the index
        serve = HalfIndexServer
    else:
        server, rows = servers(cell)

        def serve(c, corpus, dev):
            return Faulty(server, fault, rows)
    out = run(tiny, cell, seconds=0.5, serve=serve)
    assert out["attempted"] >= 1
    assert out["correct"] is False, out["checks"]
    if fault == "half_index":   # only the share of neighbours missed shows
        checks = out["checks"]
        assert checks["bad_answers"]["value"] == 0
        assert checks["dist_err"]["value"] <= checks["dist_err"]["limit"]
        assert checks["recall_miss"]["value"] > \
            checks["recall_miss"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_comes_out_not_correct(tiny, cell):
    out = run(tiny, cell, serve=ControlServer)
    assert out["failed"] == 0
    assert out["checks"]["bad_answers"]["value"] == 0
    assert out["checks"]["dist_err"]["value"] > \
        out["checks"]["dist_err"]["limit"]
    assert out["correct"] is False


def test_run_py_needs_the_card_and_prints_nothing_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cells_on_the_card_at_a_tiny_size(tiny, cell):
    """The program and the control on the card at the tiny size: correct,
    and not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for path in (tiny.parent / "benchmark" / "configs").glob("*/config.json"):
        cfg = json.loads(path.read_text())
        cfg["device"] = "cuda"
        path.write_text(json.dumps(cfg))
    good = harness.run_cell(tiny, cell, SEED, 0.5, True, dev,
                            time.perf_counter())
    bad = harness.run_cell(tiny, cell, SEED, 0.5, False, dev,
                           time.perf_counter(), serve=ControlServer)
    assert good["correct"] is True and bad["correct"] is False
    assert good["device"]["busy_s"] > 0


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_benchmark_json_keeps_its_format_limits():
    spec = SPEC
    assert list(spec) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert spec["paths"] == ["benchmark"]
    assert all(LINE.match(w) for w in spec["command"])
    assert (ROOT / spec["command"][1]).is_file()
    n = len(spec["workloads"])
    assert 1 <= n <= 24 and 1 <= spec["run_seconds"] <= 51
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    configs = {c["name"]: c for c in spec["configs"]}
    used = {w["config"] for w in spec["workloads"]}
    assert used == set(configs)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["reduced"] == []
        assert c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "traffic"
                / f"{w['traffic']}.json").is_file()
    names = set()
    for section in ("end_to_end", "per_layer"):
        assert 1 <= len(spec[section])
        for m in spec[section]:
            assert NAME.match(m["name"]) and m["name"] not in names
            names.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
            assert (ROOT / "benchmark" / "metrics"
                    / f"{m['name']}.py").is_file()
            keys = {"name", "unit", "better", "source"} | (
                {"bound"} if section == "end_to_end"
                else {"layer", "moves"})
            assert set(m) - {"workloads"} == keys
            if section == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert LINE.match(m["layer"]) and m["moves"] in names
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for w in spec["workloads"]:
        def reports(section):
            return {m["name"] for m in spec[section]
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reports("end_to_end")
        assert len(reports("end_to_end")) >= 2 and reports("per_layer")
    assert math.floor(0.25 * n) >= sum(w["chips"] == 4
                                       for w in spec["workloads"])


def test_a_fixed_corpus_takes_its_queries_from_the_seed(tiny):
    """``corpus_seed`` fixes the corpus (sift128-1m): two seeds build the
    same index and send other queries, none of them a corpus row."""
    cell = harness.load_cell(tiny, "sift128-1m.adcscan-k100-b1000")
    assert "corpus_seed" in cell.config["data"]
    x1, r1, _ = harness.make_requests(cell, SEED, CPU)
    x2, r2, _ = harness.make_requests(cell, SEED + 1, CPU)
    x3, r3, _ = harness.make_requests(cell, SEED, CPU)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(r1, r3)
    assert not np.array_equal(r1, r2)
    # a run seeded with the corpus's own seed still draws other rows
    _, r0, _ = harness.make_requests(
        cell, cell.config["data"]["corpus_seed"], CPU)
    rows = {row.tobytes() for row in x1}
    assert not any(q.tobytes() in rows for q in r0.reshape(
        -1, x1.shape[1]))
