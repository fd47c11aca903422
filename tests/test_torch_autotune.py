"""Calibrated target-recall routing on the port (services/autotune.py),
held to the contracts of tests/services/test_autotune.py and against the
JAX package's AutoTuner on the same numpy corpus:

- the calibration draw (ids, queries, self-excluded exact ground truth) is
  bit-equal to JAX's, for HNSW and IVF services;
- on one graph (the JAX service's, carried over with ``load_state``) every
  candidate mode's recall is within 0.01 of JAX's;
- under an injected clock that gives each candidate the same time in both
  packages, the decision tables (every candidate's recall and QPS, the
  chosen mode) are equal.
"""

import numpy as np
import pytest
import yaml

import vector_db_tpu.services.autotune as jax_autotune
import vector_db_tpu_torch.services.autotune as port_autotune
from vector_db_tpu.services.indexing_service import (
    IndexingService as JaxIndexingService)
from vector_db_tpu.services.storage_service import (
    StorageService as JaxStorageService)
from vector_db_tpu_torch.services.indexing_service import IndexingService
from vector_db_tpu_torch.services.storage_service import StorageService
from vector_db_tpu_torch.types import Node
from tests.test_torch_ivf import _same_init
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DIM = 16
RECALL_TOL = 0.01


def make_config(tmp_path, index_type="hnsw", **autotune):
    index = {
        "M": 8, "ef_construction": 60, "flush_threshold": 100000,
        "type": index_type,
        "autotune": {"enabled": True, "target_recall": 0.9,
                     "sample": 32, "k": 5, "ef_ladder": [64, 128],
                     "min_size": 64, **autotune},
    }
    if index_type == "hnsw":
        index["wide"] = {"enabled": True, "min_size": 64}
    else:
        index["ivf_k"] = 16
    cfg = {
        "embedding": {"model": "fake-16", "dimension": DIM},
        "device": "cpu",
        "index": index,
        "vector_db": {"file_path": str(tmp_path / "vdb"),
                      "dimension": DIM, "capacity": 2048},
    }
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def make_nodes(rng, n, metadata=True):
    return [Node(id=i,
                 embedding=rng.standard_normal(DIM).astype(np.float32),
                 metadata={"par": i % 2} if metadata else {})
            for i in range(n)]


def build_service(tmp_path, rng, n=512, index_type="hnsw", package="port",
                  **autotune):
    storage_cls, svc_cls = ((StorageService, IndexingService)
                            if package == "port" else
                            (JaxStorageService, JaxIndexingService))
    tmp_path.mkdir(parents=True, exist_ok=True)
    cfg = make_config(tmp_path, index_type, **autotune)
    storage = storage_cls(str(tmp_path / "vdb"), dim=DIM, capacity=2048)
    svc = svc_cls(storage=storage.storage, config_path=cfg)
    nodes = make_nodes(rng, n, metadata=index_type == "hnsw")
    svc.insert_nodes(nodes)
    return svc, nodes


# ---------------------------------------------------------------------------
# the contracts of tests/services/test_autotune.py
# ---------------------------------------------------------------------------

def test_routes_through_calibrated_decision(tmp_path, rng):
    svc, nodes = build_service(tmp_path, rng)
    res = svc.search(nodes[41].embedding, k=5)
    assert res[0][0].id == 41
    # exactly one decision was made, for the B=1 bucket at the default
    # target, and it meets the target (every mode is near-exact at 512)
    stats = svc._autotune.stats()
    assert list(stats) == ["b8@0.9"]
    dec = next(iter(stats.values()))
    assert dec["met"] and dec["recall"] >= 0.9
    assert dec["mode"] in ("scan-bf16", "scan-blocksel", "wide",
                           "scan-exact")

    # batch path reuses the tuner at its own bucket
    q = np.stack([n.embedding for n in nodes[:20]])
    dists, ids = svc.search_batch(q, k=3)
    assert ids.shape == (20, 3)
    assert (ids[:, 0] == [n.id for n in nodes[:20]]).all()
    assert "b32@0.9" in svc._autotune.stats()


def test_per_request_target_overrides(tmp_path, rng):
    svc, nodes = build_service(tmp_path, rng)
    q = np.stack([n.embedding for n in nodes[:8]])
    svc.search_batch(q, k=5, target_recall=1.0)
    stats = svc._autotune.stats()
    assert "b8@1" in stats
    dec = stats["b8@1"]
    # an exact-capable mode must win a recall-1.0 target on this corpus
    assert dec["met"] and dec["recall"] == 1.0


def test_recalibrates_after_growth(tmp_path, rng):
    svc, nodes = build_service(tmp_path, rng, n=256)
    svc.search(nodes[0].embedding, k=5)
    first = next(iter(svc._autotune.stats().values()))
    assert first["calibrated_at_size"] == 256

    more = [Node(id=1000 + i,
                 embedding=rng.standard_normal(DIM).astype(np.float32),
                 metadata={}) for i in range(512)]
    svc.insert_nodes(more)
    svc.search(nodes[0].embedding, k=5)
    second = next(iter(svc._autotune.stats().values()))
    assert second["calibrated_at_size"] == 768


def test_ivf_autotune_picks_n_probe(tmp_path, rng):
    svc, nodes = build_service(tmp_path, rng, index_type="ivf",
                               target_recall=0.95, sample=24)
    assert svc.index.centroids is not None

    res = svc.search(nodes[17].embedding, k=5)
    assert res[0][0].id == 17
    stats = svc._autotune.stats()
    dec = next(iter(stats.values()))
    assert dec["mode"] == "ivf" and "n_probe" in dec["params"]
    assert dec["met"] and dec["recall"] >= 0.95
    # full probe (n_probe == k_cells) always reaches 1.0, so the chosen
    # probe width must be <= the cell count and the target must be met
    assert 1 <= dec["params"]["n_probe"] <= 16

    q = np.stack([n.embedding for n in nodes[:16]])
    dists, ids = svc.search_batch(q, k=3)
    assert (ids[:, 0] == [n.id for n in nodes[:16]]).all()


def test_filtered_queries_calibrate_per_selectivity(tmp_path, rng):
    """Filtered hnsw queries route through a selectivity-bucketed
    decision (the scan/graph ranking flips with match fraction) and the
    REAL filter is always honored."""
    svc, nodes = build_service(tmp_path, rng)
    allowed = {n.id for n in nodes if n.id % 2 == 0}  # ~50% selectivity
    res = svc.search(nodes[10].embedding, k=5, filter_ids=allowed)
    assert res and all(n.id in allowed for n, _ in res)
    assert res[0][0].id == 10
    stats = svc._autotune.stats()
    assert "b8@0.9/sel0.5" in stats
    dec = stats["b8@0.9/sel0.5"]
    assert dec["met"] and dec["recall"] >= 0.9
    assert dec["mode"] in ("scan-bf16-f", "wide-f", "scan-exact-f")

    # a much more selective filter lands in its own bucket
    tiny = {n.id for n in nodes if n.id % 64 == 0}  # ~1.6%
    res2 = svc.search(nodes[64].embedding, k=3, filter_ids=tiny)
    assert res2 and all(n.id in tiny for n, _ in res2)
    assert res2[0][0].id == 64
    assert any("/sel0.02" in kk or "/sel0.01" in kk
               for kk in svc._autotune.stats())

    # batch path: same selectivity bucket is reused, filter honored
    q = np.stack([n.embedding for n in nodes[:16]])
    _, ids = svc.search_batch(q, k=3, filter_ids=allowed)
    assert all(int(v) in allowed for row in ids for v in row if v >= 0)


def test_filtered_autotune_bypassed_for_ivf(tmp_path, rng):
    svc, nodes = build_service(tmp_path, rng, index_type="ivf",
                               target_recall=0.95, sample=24)
    allowed = {n.id for n in nodes if n.id % 2 == 0}
    res = svc.search(nodes[10].embedding, k=5, filter_ids=allowed)
    assert res and all(n.id in allowed for n, _ in res)
    assert svc._autotune.stats() == {}  # ivf filters keep the direct path


# ---------------------------------------------------------------------------
# against the JAX package's AutoTuner
# ---------------------------------------------------------------------------

def _pair(tmp_path, index_type="hnsw", carry=True):
    """(JAX service, port service) over one corpus; with ``carry`` the
    port's HNSW adopts the JAX service's graph (``load_state``). IVF
    builds draw their k-means initial rows alike (test_torch_ivf's
    ``_same_init``), so both train the same cells."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        _same_init(mp, 0)
        for package in ("jax", "port"):
            svc, nodes = build_service(tmp_path / package,
                                       np.random.default_rng(7),
                                       index_type=index_type,
                                       package=package)
            out.append(svc)
    ref, port = out
    if carry and index_type == "hnsw":
        g = ref.index.graph
        port.index.load_state(
            np.asarray(g.neighbors), np.asarray(g.levels), int(g.entry),
            int(g.entry_level), np.asarray(ref.index._store.emb),
            np.asarray(ref.index._store.valid),
            ref.index._store.export_id_map())
    return ref, port, nodes


@pytest.mark.parametrize("index_type", ["hnsw", "ivf"])
def test_calibration_draw_matches_jax(tmp_path, index_type):
    """The same live ids in the same order, the same seeded draw: the
    calibration ids, queries and ground truth equal JAX's bit for bit (the
    filtered ground truth of a selectivity bucket too)."""
    ref, port, _ = _pair(tmp_path, index_type, carry=False)
    want, got = ref._autotune, port._autotune
    for svc in (ref, port):
        svc._autotune._draw_calibration(svc.index)
    np.testing.assert_array_equal(got._cal_ids, want._cal_ids)
    np.testing.assert_array_equal(got._cal_queries, want._cal_queries)
    np.testing.assert_array_equal(got._cal_gt, want._cal_gt)
    assert got._cal_size == want._cal_size == 512
    if index_type == "hnsw":
        (fw, gw), (fg, gg) = (want._draw_filter(ref.index, 0.2),
                              got._draw_filter(port.index, 0.2))
        assert fg == fw
        np.testing.assert_array_equal(gg, gw)


def _clock():
    """A perf_counter that reads i**2 at its i-th call: the j-th timed
    candidate of a calibration measures the same time in both packages."""
    calls = iter(range(1, 1 << 30))
    return lambda: float(next(calls) ** 2)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Both tuners' decisions under the injected clock: on the JAX
    service's HNSW graph at buckets 8 and 32 and at selectivity 0.5; on
    one IVF build at bucket 8."""
    out = {}
    for index_type in ("hnsw", "ivf"):
        ref, port, _ = _pair(tmp_path_factory.mktemp(index_type),
                             index_type)
        allowed = set(range(0, 512, 2))
        decisions = []
        for module, svc in ((jax_autotune, ref), (port_autotune, port)):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(module.time, "perf_counter", _clock())
                svc._autotune.decision_for(svc, 1)
                if index_type == "hnsw":
                    svc._autotune.decision_for(svc, 20)
                    svc._autotune.decision_for(svc, 1, sel_frac=len(
                        allowed) / 512)
            decisions.append(dict(svc._autotune._decisions))
        out[index_type] = decisions
    return out


@pytest.mark.parametrize("index_type", ["hnsw", "ivf"])
def test_candidate_recalls_match_jax_on_one_graph(tables, index_type):
    """On the JAX service's graph (IVF: the same build) every candidate of
    every table (the scans, the wide ladder, the filtered ladder, the
    n_probe ladder) reads a recall within 0.01 of JAX's."""
    want, got = tables[index_type]
    assert list(got) == list(want)
    for key in want:
        rows_w, rows_g = want[key]["candidates"], got[key]["candidates"]
        assert ([(r["name"], r["params"]) for r in rows_g]
                == [(r["name"], r["params"]) for r in rows_w])
        for rg, rw in zip(rows_g, rows_w):
            assert abs(rg["recall"] - rw["recall"]) <= RECALL_TOL, (key, rg,
                                                                     rw)


@pytest.mark.parametrize("index_type", ["hnsw", "ivf"])
def test_decision_tables_equal_under_injected_clock(tables, index_type):
    """Under the injected clock the decision tables (every candidate's
    recall and QPS, the chosen mode and its numbers) are equal."""
    want, got = tables[index_type]
    assert got == want
