"""The port's tracing (``vector_db_tpu_torch.observability``) on the CPU at
tiny sizes: the spans of the two routes the benchmark's cells run (the wide
beam on hnsw, the PQ full scan on ivf) nested under the service's request
in a profile, spans off costing no ``record_function``, no event and no
record, the ring of recent requests, the always-on counters, and the
benchmark's readers of the spans (``benchmark/metrics/``)."""

import json
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from benchmark import harness
from benchmark.control import ControlServer
from benchmark.program import ProgramServer
from benchmark.tests.tiny import BENCH_DIR, make_tiny_root
from benchmark.trace import Trace
from vector_db_tpu_torch import _build, observability
from vector_db_tpu_torch.observability import recording, span
from vector_db_tpu_torch.services.indexing_service import IndexingService
from vector_db_tpu_torch.storage.memory import InMemoryNodeStorage
from vector_db_tpu_torch.types import Node
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DIM = 16
ROWS = 96
INDEX = {
    "hnsw": {"type": "hnsw", "M": 4, "ef_construction": 30,
             "flush_threshold": 1000,
             "wide": {"dims": 0, "seeds": 32, "frontier": 16, "steps": 3,
                      "min_size": 16}},
    "ivf": {"type": "ivf", "ivf_k": 8, "flush_threshold": 1000,
            "pq": {"chunks": 4, "ksub": 16, "min_size": 16}},
}
PARAMS = {"hnsw": {"ef": 16}, "ivf": {"n_probe": 8}}   # ivf: every cell
ROUTE = {"hnsw": "hnsw.wide", "ivf": "ivf.pq_scan"}
SPANS = {
    "hnsw": ["vdb.wide.prep", "vdb.wide.seed"]
    + ["vdb.wide.score", "vdb.wide.merge"] * 3
    + ["vdb.wide.rerank", "vdb.to_host"],
    "ivf": ["vdb.ivf.prep", "vdb.adc_topk", "vdb.ivf.rerank", "vdb.to_host"],
}
READERS = ["host_gap_ms", "wide.score_ms", "wide.merge_ms", "adc_topk.pad"]
SEED = 2_147_483_659


def make_service(tmp_path, kind):
    cfg = tmp_path / f"{kind}.yaml"
    cfg.write_text(yaml.safe_dump({"device": "cpu", "index": INDEX[kind]}))
    return IndexingService(InMemoryNodeStorage(), str(cfg),
                           index_file=str(tmp_path / f"{kind}.npz"))


def nodes(rng, n, start=0):
    return [Node(id=start + i,
                 embedding=rng.standard_normal(DIM).astype(np.float32))
            for i in range(n)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(params=["hnsw", "ivf"])
def served(request, tmp_path, rng):
    """(kind, service filled with ROWS rows and searched once, queries)."""
    svc = make_service(tmp_path, request.param)
    svc.insert_nodes(nodes(rng, ROWS))
    svc.wait_for_flush()
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    svc.search_batch(q, 5, **PARAMS[request.param])   # trains, builds
    return request.param, svc, q


def load_reader(name):
    return harness.load_module(BENCH_DIR / "metrics" / f"{name}.py")


def test_spans_nest_under_the_request_in_the_profile(served, tmp_path):
    kind, svc, q = served
    with observability.trace(str(tmp_path / "prof")):
        svc.search_batch(q, 5, **PARAMS[kind])
    (path,) = (tmp_path / "prof").glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (req,) = [e for e in events if e["name"] == "vdb.search_batch"]
    inner = [e for e in events if e["name"].startswith("vdb.")
             and e is not req]
    assert sorted(e["name"] for e in inner) == sorted(SPANS[kind])
    for e in inner:
        assert req["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= req["ts"] + req["dur"]
    (records,) = observability.requests(1)
    assert [r["name"] for r in records] == ["vdb.search_batch"] + SPANS[kind]
    assert len({r["request"] for r in records}) == 1
    assert records[0]["parent"] is None
    assert all(r["parent"] == "vdb.search_batch" for r in records[1:])
    assert records[0]["attrs"] == {"batch": 4, "k": 5, "route": ROUTE[kind]}
    assert all(r["host_ms"] >= 0 and r["device_ms"] is None
               for r in records)


def test_spans_off_enter_no_record_function(served, monkeypatch):
    kind, svc, q = served
    last = observability.requests(1)

    def refuse(*args, **kwargs):
        raise AssertionError("entered while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert span("a") is span("b", device=torch.device("cuda"), x=1)
    d, ids = svc.search_batch(q, 5, **PARAMS[kind])
    assert ids.shape == (4, 5)
    assert observability.requests(1) == last     # no record kept
    with recording(), pytest.raises(AssertionError, match="spans are off"):
        with span("on"):
            pass


class FakeEvent:
    """A CUDA event that logs what is asked of it."""
    calls = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        FakeEvent.calls.append("record")
        self.t = time.perf_counter()

    def synchronize(self):
        FakeEvent.calls.append("synchronize")

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_device_spans_time_with_events_and_never_synchronise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize", None)
    FakeEvent.calls = []
    with recording():
        with span("vdb.outer", device=torch.device("cuda", 0), n=3) as sp:
            with span("vdb.inner", device="cuda"):
                pass
            with span("vdb.host"):
                pass
            sp.set(route="r")
    assert FakeEvent.calls == ["record"] * 4     # two pairs, no wait
    outer, inner, host = observability.requests(1)[0]
    assert FakeEvent.calls.count("synchronize") == 2   # resolved on read
    assert outer["attrs"] == {"n": 3, "route": "r"}
    assert outer["device_ms"] >= inner["device_ms"] >= 0
    assert host["device_ms"] is None and host["parent"] == "vdb.outer"


def test_the_ring_keeps_the_last_requests():
    n = observability.RING
    with recording():
        for i in range(n + 5):
            with span("vdb.req", i=i):
                with span("vdb.step"):
                    pass
    got = observability.requests(n + 100)
    assert len(got) == n
    assert [r[0]["attrs"]["i"] for r in got] == list(range(5, n + 5))
    assert all([s["name"] for s in r] == ["vdb.req", "vdb.step"]
               for r in got)
    ids = [r[0]["request"] for r in got]
    assert ids == list(range(ids[0], ids[0] + n))
    spans = observability.snapshot()["spans"]
    assert spans["vdb.req"]["count"] == spans["vdb.step"]["count"]


def counters():
    return observability.snapshot()["counters"]


def test_counters_after_inserts_and_searches(tmp_path, rng):
    before = counters()
    hnsw, ivf = make_service(tmp_path, "hnsw"), make_service(tmp_path, "ivf")
    for svc in (hnsw, ivf):
        svc.insert_nodes(nodes(rng, ROWS))
        svc.wait_for_flush()
    q = rng.standard_normal((3, DIM)).astype(np.float32)
    for _ in range(2):
        hnsw.search_batch(q, 5, **PARAMS["hnsw"])
        ivf.search_batch(q, 5, **PARAMS["ivf"])
    steady = counters()
    hnsw.search_batch(q[:1], 5, **PARAMS["hnsw"])
    ivf.search_batch(q[:1], 5, **PARAMS["ivf"])
    flat = counters()
    hnsw.insert_nodes(nodes(rng, 4, start=ROWS))  # a write: tables rebuild
    hnsw.search_batch(q, 5, **PARAMS["hnsw"])
    after = counters()

    def grew(a, b, name):
        return b.get(name, 0) - a.get(name, 0)

    assert grew(before, after, "search.requests.hnsw.wide") == 4
    assert grew(before, after, "search.queries.hnsw.wide") == 10
    assert grew(before, after, "search.requests.ivf.pq_scan") == 3
    assert grew(before, after, "search.queries.ivf.pq_scan") == 7
    assert grew(before, after, "service.lock_wait_ns") > 0
    assert grew(before, steady, "wide.mirror_builds") == 1
    assert grew(before, steady, "pq.trainings") == 1
    assert grew(before, steady, "ivf.table_builds") >= 1
    for name in ("wide.mirror_builds", "pq.trainings", "ivf.table_builds"):
        assert grew(steady, flat, name) == 0, name   # a steady window
    assert grew(flat, after, "wide.mirror_builds") == 1


def test_kernel_builds_count_the_library_loads(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: mock.MagicMock())
    before = counters().get("kernel.builds", 0)
    _build.lib()
    _build.lib()
    assert counters()["kernel.builds"] == before + 1


@pytest.fixture(scope="module")
def tiny_sift(tmp_path_factory):
    """The benchmark's tiny copy with the sift cell cut further for the
    CPU: 2,000 rows, 16 IVF cells, PQ at 16 centroids a subspace."""
    bench = make_tiny_root(tmp_path_factory.mktemp("tiny"))
    path = bench / "configs" / "sift128-1m" / "config.json"
    cfg = json.loads(path.read_text())
    cfg["rows"] = 2000
    cfg["index"]["ivf_k"] = 16
    cfg["index"]["pq"].update(ksub=16, min_size=256)
    path.write_text(json.dumps(cfg))
    traffic = bench / "traffic" / "adcscan-k100-b1000.json"
    t = json.loads(traffic.read_text())
    t["params"]["n_probe"] = 16
    traffic.write_text(json.dumps(t))
    return bench


def traced_sift(bench, make_server):
    """The tiny sift cell's run as the harness traces it (its closed loop
    with two requests profiled, the window's ``Trace``), answered by
    ``make_server(cell, corpus)``. The harness's own ``run_cell`` refuses to
    run beside the JAX package these tests load."""
    cpu = torch.device("cpu")
    cell = harness.load_cell(bench, "sift128-1m.adcscan-k100-b1000")
    corpus, pool, warm = harness.make_requests(cell, SEED, cpu)
    server = make_server(cell, corpus)
    k, params = int(cell.traffic["k"]), cell.traffic["params"]
    server(warm[0], k, params)
    answers, window_s, failed, prof = harness.run_window(
        server, pool, k, params, 0.0, 2, cpu)
    assert failed == 0
    run = harness.Run(cell, 0.0, window_s, answers, 2)
    run.trace = Trace.from_profile(prof, 2)
    return run, server


def test_adc_topk_pad_reads_the_padded_scan(tiny_sift):
    run, server = traced_sift(tiny_sift, lambda cell, corpus: ProgramServer(
        cell.config_path, corpus, torch.device("cpu"), harness.log))
    index = server.service.index
    longest = max(len(lst) for lst in index.inverted_lists)
    want = index.k * longest / 2000
    server.release()
    assert load_reader("adc_topk.pad").read(run) == pytest.approx(want)
    assert want > 1
    for reader in ("wide.score_ms", "wide.merge_ms", "host_gap_ms"):
        assert load_reader(reader).read(run) is None   # no device times


@pytest.mark.parametrize("reader", READERS)
def test_readers_read_nothing_without_the_programs_spans(tiny_sift, reader):
    """The control answers the requests: its profile holds no ``vdb.*``
    span, and records the program left in this process are not read."""
    with recording():
        with span("vdb.search_batch"):
            with span("vdb.adc_topk", device="cpu", slots=10, live=5):
                pass
    run, _ = traced_sift(tiny_sift, lambda cell, corpus: ControlServer(
        cell, corpus, torch.device("cpu")))
    assert load_reader(reader).read(run) is None
    run.trace.device.append(("k", "kernel", run.trace.start_ns,
                             run.trace.end_ns))    # a device, still no span
    assert load_reader(reader).read(run) is None


def synthetic_run():
    """Two requests in a 100 us window: the device busy 0-30 and 60-70 us;
    the program's spans 5-50 and 55-95 us (the first holding one inner
    span), the harness's span around each."""
    us = 1000
    device = [("k1", "kernel", 0, 20 * us), ("k2", "kernel", 10 * us,
                                            30 * us),
              ("k3", "kernel", 60 * us, 70 * us)]
    host = [(0, 52 * us, "bench.search_batch"),
            (5 * us, 50 * us, "vdb.search_batch"),
            (20 * us, 40 * us, "vdb.wide.score"),
            (52 * us, 100 * us, "bench.search_batch"),
            (55 * us, 95 * us, "vdb.search_batch"),
            (60 * us, 62 * us, "aten::add")]
    return SimpleNamespace(trace=Trace(0, 100 * us, 2, device, host))


def test_host_gap_ms_on_a_synthetic_trace():
    # idle inside the spans: 30-50 (20 us) and 55-60 + 70-95 (30 us)
    got = load_reader("host_gap_ms").read(synthetic_run())
    assert got == pytest.approx((20 + 30) * 1e-3 / 2)


def test_span_readers_sum_device_ms_a_request(monkeypatch):
    def rec(name, device_ms, **attrs):
        return {"name": name, "device_ms": device_ms, "attrs": attrs}

    reqs = [[rec("vdb.search_batch", None), rec("vdb.wide.score", 2.0),
             rec("vdb.wide.merge", 1.0), rec("vdb.wide.score", 3.0),
             rec("vdb.adc_topk", 4.0, slots=60, live=10)],
            [rec("vdb.search_batch", None), rec("vdb.wide.score", 1.0),
             rec("vdb.wide.merge", 0.5),
             rec("vdb.adc_topk", 4.0, slots=40, live=10)]]
    monkeypatch.setattr(observability, "requests", lambda n: reqs[-n:])
    run = synthetic_run()
    assert load_reader("wide.score_ms").read(run) == pytest.approx(3.0)
    assert load_reader("wide.merge_ms").read(run) == pytest.approx(0.75)
    assert load_reader("adc_topk.pad").read(run) == pytest.approx(5.0)
    reqs[1][1]["device_ms"] = None    # a span not timed on the device
    assert load_reader("wide.score_ms").read(run) is None
    run.trace.host.pop(1)             # one request span fewer than traced
    assert load_reader("adc_topk.pad").read(run) is None
