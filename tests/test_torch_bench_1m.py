"""scripts/bench_1m_torch.py against scripts/bench_1m.py on the CPU, at
2,048 x 768 embedding-like rows (``embedding_like(N + 1000, 768, seed=0)``,
the script's corpus and its first 16 queries), IVF at 16 cells.

scripts/bench_1m.py takes N from BENCH_N but fixes its queries at 1000,
and at 1000 queries on the CPU one wide-beam call takes about a minute in
either package (the script makes 17 graph calls and their timed reps), so
the test composes the script's JAX calls, section by section, at 16
queries on the corpus the port's ``run`` is handed (``b=16``), in a
process of its own (JAX_PLATFORMS=cpu) started beside the port's run.
Below 8,192 rows both packages build the same graph (the host branch). The
port adopts the JAX index's trained OPQ codec and the JAX IVF's centroids,
which that process leaves first (k-means draws its initial rows from a
``torch.Generator`` by design). The port's timing is patched to make no
call.

Held, row by row by name (every row of BENCH_1M.json in the port's file):
- ``exact_f32`` and ``blocksel_exact`` (lossless by construction): 1.0 on
  both sides;
- the scan and block rows (``bf16_scan``, ``blocksel_*``, the filtered
  ``scan`` and ``scan_exact``): within 0.01;
- the graph rows (wide, beam, classic, RP, filtered wide and classic) and
  the IVF and PQ rows (``hnsw_opq``, ``ivf_rp``) and the probe ceilings:
  within 0.02 (one id in 160 is 0.00625).
"""

import contextlib
import io
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import vector_db_tpu_torch.index.ivf as port_ivf
import vector_db_tpu_torch.index.pq as port_pq
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.datasets import embedding_like
from vector_db_tpu.index.hnsw import HNSW
from vector_db_tpu.index.ivf import IvfIndex
from vector_db_tpu.ops.exact import (
    approx_search_tiled,
    block_select_search,
    block_select_search_2p,
    block_select_search_3p,
    exact_search_tiled,
)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_1m_torch as port  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, Q, CELLS, K = 2048, 16, 16, 10
SCAN_TOL, OTHER_TOL = 0.01, 0.02
LOSSLESS = ("exact_f32", "blocksel_exact")
JAX_SECONDS = 900


def _recall(ids, gt):
    ids, gt = np.asarray(ids), np.asarray(gt)
    return float(np.mean([len(set(ids[i][:K].tolist()) & set(gt[i].tolist()))
                          / K for i in range(len(gt))]))


def _leave(path, **arrays):
    np.savez(path.with_suffix(".part.npz"), **arrays)
    os.replace(path.with_suffix(".part.npz"), path)


def jax_bench_1m(out_dir):
    """scripts/bench_1m.py's calls, every section, at N rows and Q queries,
    run as a process of its own beside the port's: first the OPQ codec and
    the IVF (left in ``out_dir`` as codec.npz and centroids.npz for the
    port to adopt), then the rows in the script's order, the probe
    ceilings by the script's host loop and the truth, left as
    result.json."""
    out_dir = Path(out_dir)
    x, q = _corpus()
    n = x.shape[0]
    tile = 31250 if n % 31250 == 0 else 25000
    index = HNSW(M=16, ef_construction=200, rng=random.Random(42),
                 capacity=n, l_max=5)
    index.bulk_build(list(range(n)), x)
    # the codec and the cells first, so the port waits least; neither
    # touches the rows before the script's opq and ivf sections
    index.enable_pq(chunks=16, ksub=256, opq_iters=8)
    rot = {} if index._pq.rotation is None else {
        "r": np.asarray(index._pq.rotation)}
    _leave(out_dir / "codec.npz", cb=np.asarray(index._pq.codebooks), **rot)
    ivf = IvfIndex(k=CELLS)
    ivf.build_arrays(range(n), x, seed=0, iters=20, spill=2,
                     list_cap_alpha=2.0)
    _leave(out_dir / "centroids.npz", c=np.asarray(ivf.centroids))
    qd = jnp.asarray(q)
    emb, has = index._emb, index._has_emb
    gt = np.asarray(exact_search_tiled(qd, emb, has, K, tile=tile)[1])
    res = {"exact_f32": {"recall": 1.0}, "hnsw": [], "hnsw_opq": []}

    # scan, scan3p, scan2p
    emb16 = emb.astype(jnp.bfloat16)
    x_sq = jax.jit(lambda e: jnp.sum(e * e, -1))(emb)
    res["bf16_scan"] = {"recall": _recall(approx_search_tiled(
        qd, emb16, has, K, tile=tile, x_sq=x_sq)[1], gt)}
    for name, tab, extra in [
            ("blocksel_exact", emb, {"exact_phase1": True, "blocks_k": K}),
            ("blocksel_bf16", emb16, {"blocks_k": 2 * K}),
            ("blocksel_bf16_k", emb16, {"blocks_k": K})]:
        res[name] = {"recall": _recall(block_select_search(
            qd, tab, qd, x_sq, emb, has, K, tile=131072, **extra)[1], gt)}
    index.enable_rp(dims=128)
    rp_tab, rp_xsq = index._rp_tables()
    qp = jnp.dot(qd, index._rp_proj, preferred_element_type=jnp.float32)
    for name, bk in [("blocksel_proj_k", K), ("blocksel_proj", 2 * K),
                     ("blocksel_proj_4k", 4 * K)]:
        res[name] = {"recall": _recall(block_select_search(
            qd, rp_tab, qp, rp_xsq, emb, has, K, tile=131072,
            blocks_k=bk)[1], gt)}
    res["blocksel_3p"] = {"recall": _recall(block_select_search_3p(
        qd, rp_tab, qp, x_sq, emb, has, K, tile=131072, blocks_k=2 * K,
        rows_k=8 * K, pallas_phase1=True)[1], gt)}
    res["blocksel_2p"] = {"recall": _recall(block_select_search_2p(
        qd, rp_tab, qp, x_sq, emb, has, K, block=128, m=2,
        rows_k=8 * K)[1], gt)}

    # wide, beam, hnsw
    index.enable_wide(dims=120, seeds=16384, inline=True)
    res["hnsw_wide"] = [
        {"ef": ef, "F": f, "T": t, "seen": seen,
         "recall": _recall(index.search_batch_wide(
             q, k=K, ef=ef, frontier=f, steps=t, seen_mask=seen)[1], gt)}
        for ef, f, t, seen in port.WIDE]
    res["hnsw_beam"] = [
        {"F": f, "T": t, "hist": h, "recall": _recall(
            index.search_batch_beam(q, k=K, frontier=f, steps=t,
                                    hist=h)[1], gt)}
        for f, t, h in port.BEAM]
    res["hnsw"] = [{"ef": ef, "recall": _recall(index.search_batch(
        q, k=K, ef=ef, expand=4)[1], gt)} for ef in port.CLASSIC_EFS]

    # filter
    res["hnsw_filtered"] = []
    for sel in port.SELECTIVITY:
        fslots = np.random.default_rng(11).choice(n, size=int(n * sel),
                                                  replace=False)
        filt = set(int(i) for i in fslots)
        fmask = np.zeros((index._capacity,), bool)
        fmask[fslots] = True
        gt_f = np.asarray(exact_search_tiled(
            qd, emb, jnp.asarray(fmask) & has, K, tile=31250)[1])
        calls = {
            "scan": lambda: index.search_batch_scan(q, k=K,
                                                    filter_ids=filt),
            "scan_exact": lambda: index.search_batch_scan(
                q, k=K, mode="exact", filter_ids=filt),
            "wide": lambda: index.search_batch_wide(
                q, k=K, ef=1280, frontier=224, steps=10, rerank_k=256,
                seen_mask=False, filter_ids=filt),
            "wide_deep": lambda: index.search_batch_wide(
                q, k=K, ef=1536, frontier=224, steps=12, rerank_k=512,
                seen_mask=False, filter_ids=filt),
            "classic": lambda: index.search_batch(
                q, k=K, ef=400, expand=4, filter_ids=filt)}
        for name, call in calls.items():
            if name == "classic" and sel != 0.1:
                continue
            res["hnsw_filtered"].append(
                {"engine": name, "selectivity": sel,
                 "recall": _recall(call()[1], gt_f)})

    # rp, opq, widepq
    index.enable_rp(dims=128)
    res["hnsw_rp"] = [{"ef": ef, "recall": _recall(index.search_batch_rp(
        q, k=K, ef=ef, expand=4)[1], gt)} for ef in port.RP_EFS]
    res["hnsw_opq"].append({"ef": 400, "recall": _recall(
        index.search_batch_pq(q, k=K, ef=400, expand=4)[1], gt)})
    for ef, f, t in port.WIDE_PQ:
        res["hnsw_opq"].append({"ef": ef, "F": f, "T": t, "mode": "wide",
                                "recall": _recall(index.search_batch_wide(
                                    q, k=K, ef=ef, frontier=f, steps=t,
                                    score="pq", rerank_k=ef)[1], gt)})

    # ivf, and the probe ceilings by scripts/bench_1m.py's host loop
    ivf.enable_rp(dims=128)
    res["ivf_rp"] = {"ops": [
        {"n_probe": p, "fetch": f, "recall": _recall(ivf.search_batch(
            q, n_probe=p, top_k=K, rp=True, fetch=f)[1], gt)}
        for p, f in [(64, 128), (256, 256), (CELLS, 64)]]}
    cell_of = [[] for _ in range(n)]
    for c, lst in enumerate(ivf.inverted_lists):
        for nid in lst:
            cell_of[nid].append(c)
    cents = np.asarray(ivf.centroids)
    order = np.argsort((cents * cents).sum(-1)[None, :]
                       - 2.0 * (q @ cents.T), axis=1)
    ceil = {}
    for n_probe in port.IVF_PROBES:
        probed = [set(order[i, :n_probe].tolist()) for i in range(len(q))]
        ceil[str(n_probe)] = float(np.mean(
            [[bool(set(cell_of[g]) & probed[i]) for g in gt[i]]
             for i in range(len(q))]))
    (out_dir / "part.json").write_text(json.dumps(
        {"rows": res, "probe_ceiling": ceil, "gt": gt.tolist()}))
    os.replace(out_dir / "part.json", out_dir / "result.json")


def _corpus():
    data = embedding_like(N + 1000, 768, 0)
    return data[:N], np.ascontiguousarray(data[N:N + Q])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Start the JAX composition in a process of its own; yields
    ``part(name)``, which waits for one of its files and reads it."""
    cwd = tmp_path_factory.mktemp("jax_1m")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    err = open(cwd / "stderr.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import tests.test_torch_bench_1m as t; "
         f"t.jax_bench_1m({str(cwd)!r})"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)

    def part(name):
        path = cwd / name
        t0 = time.monotonic()
        while not path.exists():
            assert proc.poll() in (None, 0), Path(err.name).read_text()[-3000:]
            assert time.monotonic() - t0 < JAX_SECONDS, f"no {name}"
            time.sleep(0.2)
        if name.endswith(".json"):
            return json.loads(path.read_text())
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    yield part
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    err.close()


@pytest.fixture(scope="module")
def both(one_torch_thread, jax_run, tmp_path_factory):  # noqa: F811
    x, q = _corpus()
    out = tmp_path_factory.mktemp("b1m") / "out.json"
    keep, buf = {}, io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        def jax_codec(self, *a, **kw):
            z = jax_run("codec.npz")
            other = port_pq.PQCodec.from_arrays(z["cb"], z.get("r"),
                                                device="cpu")
            self.codebooks, self.rotation = other.codebooks, other.rotation

        mp.setattr(port_pq.PQCodec, "train", jax_codec)
        mp.setattr(port_ivf, "kmeans", lambda *a, **kw: (
            torch.from_numpy(jax_run("centroids.npz")["c"]), None))
        mp.setattr(port, "card", lambda: "rehearsal card, 700 W")
        mp.setattr(port, "timed", lambda run, q, n_q: (1.0, None))
        with contextlib.redirect_stdout(buf):
            got = port.run(N, "cpu", out, source={"x": x, "q": q}, b=Q,
                           k_cells=CELLS, keep=keep)
    want = jax_run("result.json")
    return got, want, keep, out, buf.getvalue()


def _tol(name):
    if name in LOSSLESS:
        return 0.0
    scans = ("bf16_scan", "blocksel", "engine=scan,", "engine=scan_exact")
    return SCAN_TOL if any(s in name for s in scans) else OTHER_TOL


def test_rows_match_jax(both):
    got, want = both[:2]
    g, w = chip_smoke.recall_rows(got), chip_smoke.recall_rows(want["rows"])
    assert set(w) <= set(g), sorted(set(w) - set(g))
    assert len(w) == 38
    for name, val in w.items():
        assert abs(g[name] - val) <= _tol(name), (name, g[name], val)
    for name in LOSSLESS:
        assert g[name] == w[name] == 1.0, name


def test_probe_ceilings_match_jax(both):
    got, want = both[:2]
    assert set(got["ivf_rp"]["probe_ceiling"]) == set(want["probe_ceiling"])
    for n_probe, ceil in want["probe_ceiling"].items():
        assert abs(got["ivf_rp"]["probe_ceiling"][n_probe] - ceil) \
            <= OTHER_TOL, (n_probe, ceil)
    # the two exact truths (a near-tie at the 10th place may swap)
    assert _recall(both[2]["gt"], want["gt"]) >= 0.99


def test_rows_named_as_bench_1m_json(both):
    got, _, keep, out, printed = both
    jax_file = json.loads((ROOT / "BENCH_1M.json").read_text())
    text = json.dumps(jax_file).replace('"n_probe": 4096',
                                        f'"n_probe": {CELLS}')
    names = set(chip_smoke.recall_rows(json.loads(text)))
    assert names <= set(chip_smoke.recall_rows(got)), sorted(
        names - set(chip_smoke.recall_rows(got)))
    assert set(jax_file) <= set(got), sorted(set(jax_file) - set(got))
    assert set(jax_file["ivf_rp"]) <= set(got["ivf_rp"])
    assert got["B"] == Q and got["card"] == "rehearsal card, 700 W"
    assert keep["hnsw"].size == N and len(keep["gt"]) == Q
    assert [json.loads(line) for line in printed.strip().splitlines()] == [
        got]
    assert json.loads(out.read_text()) == got
