"""scripts/bench_latency_torch.py against scripts/bench_latency.py (and the
two rows scripts/exp_latency_addendum.py appends) on the CPU, at 2,048
SIFT-shaped rows in 32 cells with 256 queries, and 2,048 x 768
embedding-like rows with 16 queries.

scripts/bench_latency.py fixes N at 1M (and its 1M x 768 half at 1000
queries, whose wide calls take about a minute each on the CPU), so the test
composes its JAX calls at the small sizes on the corpora the port's ``run``
is handed: IvfIndex(32) spill 2 with RP at 128 dims and the three SIFT
modes; the HNSW of scripts/bench_1m.py with ``enable_wide(dims=128,
seeds=4096)`` and the six 768-d modes. The port's IVF build adopts the JAX
index's centroids (its k-means draws its initial rows from a
``torch.Generator`` by design); below 8,192 rows both packages build the
same graph (the host branch). The port's timing is patched to make no call
(times are the card's).

Held, each mode's recall@10 against the f32 exact truth (the port carries
it on every row; JAX's SIFT rows carry none, so the test computes JAX's):
the exact rows at 1.0 on both sides, the scan and block rows (bf16_scan,
blocksel_3p) within 0.01, ``ivf_rp_probe8`` (an IVF row) and the graph
rows within 0.02 (one id in 160 is 0.00625); every row name of
BENCH_LATENCY.json in the port's file, each at B 1 / 8 / 64.
"""

import contextlib
import io
import json
import random
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import vector_db_tpu_torch.index.ivf as port_ivf
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.datasets import embedding_like, sift_like
from vector_db_tpu.index.hnsw import HNSW
from vector_db_tpu.index.ivf import IvfIndex
from vector_db_tpu.ops.exact import (
    approx_search_tiled,
    block_select_search_3p,
    exact_search_tiled,
)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_latency_torch as port  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, CELLS, GRAPH_Q, K = 2048, 32, 16, 10
SCAN_TOL, OTHER_TOL = 0.01, 0.02


def _recall(ids, gt):
    ids, gt = np.asarray(ids), np.asarray(gt)
    return float(np.mean([len(set(ids[i][:K].tolist()) & set(gt[i].tolist()))
                          / K for i in range(len(gt))]))


def jax_sift(x, q):
    """bench_latency.py's SIFT half at len(x) rows: (recalls, the index)."""
    ivf = IvfIndex(k=CELLS)
    ivf.build_arrays(range(x.shape[0]), x, seed=0, iters=20, spill=2,
                     list_cap_alpha=2.0)
    ivf.enable_rp(dims=128)
    emb16 = ivf._emb.astype(jnp.bfloat16)
    x_sq = jax.jit(lambda e: jnp.sum(e * e, -1))(ivf._emb)
    qd = jnp.asarray(q)
    gt = ivf._store.ids_of(np.asarray(exact_search_tiled(
        qd, ivf._emb, ivf._has_emb, K, tile=31250)[1]))
    bf16 = np.asarray(approx_search_tiled(qd, emb16, ivf._has_emb, K,
                                          tile=131072, x_sq=x_sq)[1])
    rec = {"exact_f32": 1.0,
           "bf16_scan": _recall(ivf._store.ids_of(bf16), gt),
           "ivf_rp_probe8": _recall(ivf.search_batch(
               q, n_probe=8, top_k=K, rp=True, fetch=128)[1], gt)}
    return rec, ivf


def jax_graph(x, q):
    """bench_latency.py's 1M x 768 half and the addendum's two modes at
    len(x) rows: {mode: recall}."""
    n = x.shape[0]
    index = HNSW(M=16, ef_construction=200, rng=random.Random(42),
                 capacity=n, l_max=5)
    index.bulk_build(list(range(n)), x)
    gt = np.asarray(exact_search_tiled(jnp.asarray(q), index._emb,
                                       index._has_emb, K, tile=25000)[1])
    index.enable_wide(dims=128, seeds=4096)
    emb = index._emb
    emb16 = emb.astype(jnp.bfloat16)
    x_sq = jax.jit(lambda e: jnp.sum(e * e, -1))(emb)
    cov = np.asarray(jnp.dot(emb.T, emb,
                             preferred_element_type=jnp.float32)) / n
    _, vecs = np.linalg.eigh(cov.astype(np.float64))
    proj = jnp.asarray(vecs[:, ::-1][:, :128].astype(np.float32))
    ptab = jnp.dot(emb, proj,
                   preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    qv = jnp.asarray(q)
    rec = {}
    for name, ef, fr, steps, ee in (
            ("wide_ef512_ee", 512, 64, 12, True),
            ("wide_ef512", 512, 64, 12, False),
            ("wide_ef256_ee", 256, 32, 12, True),
            ("wide_ef1280_f256_ee", 1280, 256, 8, True)):
        rec[name] = _recall(index.search_batch_wide(
            q, K, ef=ef, frontier=fr, steps=steps, early_exit=ee)[1], gt)
    rec["bf16_scan"] = _recall(approx_search_tiled(
        qv, emb16, index._has_emb, K, tile=125000, x_sq=x_sq)[1], gt)
    rec["blocksel_3p"] = _recall(block_select_search_3p(
        qv, ptab, jnp.dot(qv, proj, preferred_element_type=jnp.float32),
        x_sq, emb, index._has_emb, K, tile=131072, blocks_k=2 * K,
        rows_k=4 * K, pallas_phase1=True, p2_chunk=2)[1], gt)
    return rec


@pytest.fixture(scope="module")
def both(one_torch_thread, tmp_path_factory):  # noqa: F811
    xs, qs = sift_like(N, dim=128, seed=0, queries=port.SIFT_Q)
    want_sift, jivf = jax_sift(xs, qs)
    data = embedding_like(N + GRAPH_Q, 768, 0)
    xg, qg = data[:N], np.ascontiguousarray(data[N:])
    want_graph = jax_graph(xg, qg)
    out = tmp_path_factory.mktemp("lat") / "out.json"
    cents = torch.from_numpy(np.asarray(jivf.centroids).copy())
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ivf, "kmeans", lambda *a, **kw: (cents, None))
        mp.setattr(port, "card", lambda: "rehearsal card, 700 W")
        mp.setattr(port, "batch_ms", lambda run, q, cuda, reps: (1.0, None))
        with contextlib.redirect_stdout(buf):
            got = port.run(N, "cpu", out, k_cells=CELLS,
                           sift_source={"x": xs, "q": qs},
                           graph_source={"x": xg, "q": qg})
    return got, want_sift, want_graph, out, buf.getvalue()


def _tol(mode):
    return SCAN_TOL if mode in ("bf16_scan", "blocksel_3p") else OTHER_TOL


def test_sift_half_recall_matches_jax(both):
    got, want, _, _, _ = both
    rows = got["rows"]
    assert [(r["batch"], r["mode"]) for r in rows] == [
        (b, m) for b in port.BATCHES for m in want]
    for r in rows:
        w = want[r["mode"]]
        if r["mode"] == "exact_f32":
            assert r["recall"] == w == 1.0
        assert abs(r["recall"] - w) <= _tol(r["mode"]), (r, w)
    assert got["sift_queries"] == port.SIFT_Q and got["N"] == N


def test_graph_half_recall_matches_jax(both):
    got, _, want, _, _ = both
    rows = got["graph_1m_768"]["rows"]
    assert {r["mode"] for r in rows} == set(want)
    for r in rows:
        assert abs(r["recall"] - want[r["mode"]]) <= _tol(r["mode"]), (
            r, want[r["mode"]])
    assert sorted(got["graph_1m_768"]["addendum_modes"]) == [
        "blocksel_3p", "wide_ef1280_f256_ee"]


def test_rows_named_as_bench_latency_json(both):
    got, _, _, out, printed = both
    jax_file = json.loads((ROOT / "BENCH_LATENCY.json").read_text())
    for part in (jax_file, jax_file["graph_1m_768"]):
        mine = got if part is jax_file else got["graph_1m_768"]
        assert {(r["batch"], r["mode"]) for r in part["rows"]} == {
            (r["batch"], r["mode"]) for r in mine["rows"]}
    # every key but the relay floor's, which device_ms replaces
    relay = {"relay_floor_ms", "addendum_floor_ms"}
    assert set(jax_file) <= set(got)
    assert set(jax_file["graph_1m_768"]) - relay <= set(got["graph_1m_768"])
    assert all(set(r) - {"device_ms_est"} <= set(m) for r, m in zip(
        jax_file["graph_1m_768"]["rows"], got["graph_1m_768"]["rows"]))
    names = set(chip_smoke.recall_rows(jax_file))
    assert names <= set(chip_smoke.recall_rows(got))
    assert [json.loads(line) for line in printed.strip().splitlines()] == [
        got]
    assert json.loads(out.read_text()) == got
