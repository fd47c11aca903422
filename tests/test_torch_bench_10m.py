"""scripts/bench_10m_torch.py and scripts/dryrun_sharded_10m_torch.py (the
10M x 768 configuration on the port, one card and 8 shards) against
scripts/bench_10m.py and scripts/dryrun_sharded_10m.py on the CPU, at one
chunk (131,072 rows) and 8 x 65,536 rows.

The JAX scripts run in subprocesses (JAX_PLATFORMS=cpu, the output and the
compile cache in a temporary directory, so nothing in the repo is written),
started together when the module begins. Their corpora are rebuilt here with
the scripts' own formulas (the same keys, split and fold_in) and handed to
the port's ``run`` as its ``source``; the timed reps are patched to one call.

Held: each blocks_k's recall, the routed holdout and the filtered recall
within 0.01 of the JAX run's (one id in 1,000 is 0.001; on the CPU
``approx_min_k`` selects exactly), the routed blocks_k equal, no filtered-out
id in the filtered answers; the tables (int8 mirror and scales exactly, the
bf16 mirror to a bf16 step, the truths against float64 at rtol 1e-5 / atol
1e-5 with ids equal but between tied values) and stage 1 against the Pallas
``block_min_scan`` in interpret mode (rtol 1e-5 / atol 1e-5, as
test_torch_kernels.py holds it). Sharded: recall within 0.01 of the JAX
dry-run's (one id in 160 is 0.00625), the merged answer equal to a
single-table search over the shards' concatenated tables with 32 blocks
chosen in each shard's range (the same tolerance), recall at or above a
single-table search choosing 32 blocks over the whole table, and the plain
stable merge equal to ``_merge_gathered`` on ties.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_topk_parity, n, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.ops.pallas.block_min import block_min_scan as jax_block_min
from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan
from vector_db_tpu_torch.parallel.mesh import make_mesh
from vector_db_tpu_torch.parallel.sharded import _merge_gathered

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_10m_torch as one  # noqa: E402
import dryrun_sharded_10m_torch as sh  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = one.CHUNK                  # one chunk, the smallest N bench_10m.py takes
SH_N = sh.SHARDS * sh.CHUNK    # one chunk a shard
TOL = 0.01
JAX_SECONDS = 900


def _jax_gen(k, n_rows, mix):
    """bench_10m.py's and dryrun_sharded_10m.py's ``gen``."""
    z = jax.random.normal(k, (n_rows, one.INTRINSIC), jnp.float32)
    x = z @ mix + 0.12 * jax.random.normal(
        jax.random.fold_in(k, 1), (n_rows, one.DIM), jnp.float32)
    return np.asarray(x / jnp.linalg.norm(x, axis=1, keepdims=True))


@pytest.fixture(scope="module")
def one_source():
    """bench_10m.py's mixture, QR extra, queries and chunk 0 (key 7)."""
    k_mix, k_q, k_chunks = jax.random.split(jax.random.key(7), 3)
    mix = jax.random.normal(k_mix, (one.INTRINSIC, one.DIM), jnp.float32)
    extra = jax.random.normal(jax.random.fold_in(k_mix, 2),
                              (one.DIM, one.DP), jnp.float32)
    return {"mix": np.asarray(mix), "extra": np.asarray(extra),
            "queries": _jax_gen(k_q, one.B, mix),
            "chunks": [_jax_gen(jax.random.fold_in(k_chunks, 0), one.CHUNK,
                                mix)]}


def _sharded_source():
    """dryrun_sharded_10m.py's mixture, QR extra, queries (key 11) and each
    shard's chunk 0 (fold_in(key(23), shard))."""
    k_mix, k_q = jax.random.split(jax.random.key(11))
    mix = jax.random.normal(k_mix, (one.INTRINSIC, one.DIM), jnp.float32)
    extra = jax.random.normal(jax.random.fold_in(k_mix, 2),
                              (one.DIM, sh.DP), jnp.float32)
    return {"mix": np.asarray(mix), "extra": np.asarray(extra),
            "queries": _jax_gen(k_q, sh.B, mix),
            "chunks": [[_jax_gen(jax.random.fold_in(jax.random.fold_in(
                jax.random.key(23), s), 0), sh.CHUNK, mix)]
                for s in range(sh.SHARDS)]}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Start both JAX scripts on the CPU, each in a temporary directory;
    yields ``result(name)``, which waits for that run and reads its JSON."""
    runs = {}
    for name, script, out, knob, size in (
            ("one", "bench_10m.py", "BENCH_10M.json", "BENCH10M_N", N),
            ("sharded", "dryrun_sharded_10m.py", "BENCH_SHARDED_10M.json",
             "DRYRUN10M_N", SH_N)):
        cwd = tmp_path_factory.mktemp(f"jax_{name}")
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "VDB_FORCE_PLATFORM": "cpu",
               "VDB_TPU_COMPILE_CACHE": str(cwd / "cache"), knob: str(size)}
        err = open(cwd / "stderr.log", "w")
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "scripts" / script)], cwd=cwd,
            env=env, stdout=subprocess.DEVNULL, stderr=err)
        runs[name] = (proc, err, cwd / out)

    def result(name):
        proc, err, out = runs[name]
        rc = proc.wait(timeout=JAX_SECONDS)
        err.close()
        assert rc == 0, Path(err.name).read_text()[-3000:]
        return json.loads(out.read_text())

    yield result
    for proc, err, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


def _once(call, q, proj, reps):
    """``timed`` at one call: its answer, and no time (the CPU's measures
    nothing here)."""
    return call(q, q @ proj), [(1.0, None)]


def _once_piped(call, q, proj, reps, depth):
    call(q, q @ proj)
    return 1.0


# -- the sharded form ---------------------------------------------------------

@pytest.fixture(scope="module")
def sharded(one_torch_thread, jax_runs, tmp_path_factory):  # noqa: F811
    """The port's dry-run on the JAX dry-run's corpus, its shards kept."""
    src = _sharded_source()
    kept = []
    out = tmp_path_factory.mktemp("sharded") / "out.json"
    with pytest.MonkeyPatch.context() as mp:
        real = sh.build_shards
        mp.setattr(one, "card", lambda: "rehearsal card, 700 W")
        mp.setattr(one, "timed", _once)
        mp.setattr(sh, "build_shards",
                   lambda *a: kept.append(real(*a)) or kept[-1])
        results = sh.run(SH_N, "cpu", out, source=src)
    return results, kept[0], src, out


def test_sharded_recall_matches_jax_dryrun(sharded, jax_runs):
    results, shards, _, out = sharded
    want = jax_runs("sharded")
    assert want["N"] == results["N"] == SH_N
    assert abs(results["recall_at_10"] - want["recall_at_10"]) <= TOL, (
        results["recall_at_10"], want["recall_at_10"])
    assert json.loads(out.read_text()) == results
    assert results["card"] == "rehearsal card, 700 W"
    assert len(shards) == sh.SHARDS
    assert all(s.mirror.dtype == torch.float32 for s in shards)
    assert results["memory_gb_total"]["total"] == pytest.approx(
        sum(s.nbytes()["total"] for s in shards))


def _concatenated(shards):
    return one.Tables(*(torch.cat([getattr(s, f) for s in shards])
                        for f in ("mirror", "xsq_eff", "xi8", "scales")),
                      None, None, torch.float32)


def test_sharded_equals_single_table_search(sharded):
    results, shards, src, _ = sharded
    cat = _concatenated(shards)
    queries = t(src["queries"])
    qm = queries @ one.projection(t(src["mix"]), t(src["extra"]))
    mesh = make_mesh(devices=["cpu"] * sh.SHARDS)
    md, mi, _ = sh.search_sharded(shards, mesh, queries, qm, sh.BLOCKS_K)

    # one table, 32 blocks chosen in each shard's range
    nbs = shards[0].xi8.shape[0] // one.BLOCK
    mins = block_min_scan(qm, cat.mirror, cat.xsq_eff)
    per = torch.topk(mins.view(sh.B, sh.SHARDS, nbs), sh.BLOCKS_K, dim=2,
                     largest=False).indices
    bidx = (per + torch.arange(sh.SHARDS)[:, None] * nbs).view(sh.B, -1)
    d, ids = one.rerank_all(cat, queries, bidx, cat.xsq_eff)
    assert_topk_parity(md, mi, d, ids)

    # one table, 32 blocks over the whole table
    shard_pad = shards[0].xi8.shape[0]
    _, gt = sh.plain_merge(
        [n(s.truth[0]) for s in shards],
        [n(s.truth[1]) + sid * shard_pad for sid, s in enumerate(shards)],
        one.K)
    _, single = one.search(cat, queries, qm, sh.BLOCKS_K)
    assert one.recall_vs(n(mi), gt) == results["recall_at_10"]
    assert results["recall_at_10"] >= one.recall_vs(n(single), gt)


def test_plain_merge_matches_merge_gathered_on_ties():
    rng = np.random.default_rng(0)
    vals = np.sort(rng.integers(0, 4, (sh.SHARDS, 6, one.K)), axis=2)
    vals = vals.astype(np.float32)
    ids = rng.permutation(sh.SHARDS * 6 * one.K).astype(np.int32).reshape(
        vals.shape)
    mesh = make_mesh(devices=["cpu"] * sh.SHARDS)
    md, mi = _merge_gathered([t(v) for v in vals], [t(i) for i in ids],
                             one.K, mesh)
    pd, pi = sh.plain_merge(vals, ids, one.K)
    np.testing.assert_array_equal(n(md), pd)
    np.testing.assert_array_equal(n(mi), pi)


# -- one card -----------------------------------------------------------------

def test_tables_against_float64_and_stage1_against_pallas(one_source):
    """build_tables on the JAX script's chunk (64 of its queries): the
    projection, both mirrors and the norms, the plain and filtered truths
    against float64, and stage 1 (plain and filtered norms) against the
    Pallas kernel on the same table."""
    src = {**one_source, "queries": one_source["queries"][:64]}
    mix, extra, queries, rows_of = one.given_source(src, torch.device("cpu"))
    proj = one.projection(mix, extra)
    tab = one.build_tables(queries, proj, rows_of, N, one.CHUNK,
                           torch.bfloat16)
    x = src["chunks"][0]
    p = n(proj)
    np.testing.assert_allclose(p.T @ p, np.eye(one.DP), atol=1e-5)
    m = src["mix"]
    assert np.abs(m - m @ p @ p.T).max() <= 1e-4 * np.abs(m).max()

    scale = np.maximum(np.abs(x).max(axis=1), np.float32(1e-9)) / \
        np.float32(127.0)
    np.testing.assert_array_equal(n(tab.scales), scale)
    np.testing.assert_array_equal(
        n(tab.xi8), np.round(x / scale[:, None]).astype(np.int8))
    assert tab.mirror.dtype == torch.bfloat16
    np.testing.assert_allclose(n(tab.mirror), x @ p, rtol=2 ** -7,
                               atol=1e-6)
    np.testing.assert_allclose(n(tab.xsq_eff), (x * x).sum(1), rtol=1e-5)

    xd, qd = x.astype(np.float64), n(queries).astype(np.float64)
    d64 = ((qd * qd).sum(1)[:, None] - 2.0 * qd @ xd.T
           + (xd * xd).sum(1)[None, :])
    keep = np.arange(N) % one.FILTER_EVERY == 0
    for (d, ids), mask in ((tab.truth, None), (tab.truth_filtered, keep)):
        dm = d64 if mask is None else np.where(mask, d64, np.inf)
        order = np.argsort(dm, axis=1, kind="stable")[:, :one.K + 1]
        assert_topk_parity(d, ids, np.take_along_axis(dm, order, axis=1),
                           order, extra=1)
    assert (n(tab.truth_filtered[1]) % one.FILTER_EVERY == 0).all()

    qm = queries @ proj
    nb = N // one.BLOCK
    for xsq in (tab.xsq_eff, one.filtered_norms(tab)):
        got = block_min_scan(qm, tab.mirror, xsq)
        want = jax_block_min(
            jnp.asarray(n(qm)), jnp.asarray(n(tab.mirror)).astype(
                jnp.bfloat16), jnp.asarray(n(xsq)),
            block=one.BLOCK, tile=4096, qtile=64, interpret=True)
        assert got.shape == (64, nb)
        np.testing.assert_allclose(n(got), n(want)[:, :nb], rtol=1e-5,
                                   atol=1e-5)


def test_bench_10m_matches_jax_run(one_source, jax_runs, monkeypatch,
                                   tmp_path, capsys):
    monkeypatch.setattr(one, "card", lambda: "rehearsal card, 700 W")
    monkeypatch.setattr(one, "timed", _once)
    monkeypatch.setattr(one, "timed_pipelined", _once_piped)
    filtered = []
    real_search = one.search

    def search(tab, q, qm, blocks_k, xsq_eff=None):
        d, ids = real_search(tab, q, qm, blocks_k, xsq_eff)
        if xsq_eff is not None:
            filtered.append(n(ids))
        return d, ids
    monkeypatch.setattr(one, "search", search)
    out = tmp_path / "out.json"

    got = one.run(N, "cpu", out, source=one_source)
    want = jax_runs("one")

    assert [o["blocks_k"] for o in got["ops"]] == \
        [o["blocks_k"] for o in want["ops"]] == list(one.BLOCKS_K)
    for g, w in zip(got["ops"], want["ops"]):
        assert abs(g["recall"] - w["recall"]) <= TOL, (g, w)
    assert got["routed"]["blocks_k"] == want["routed"]["blocks_k"]
    assert abs(got["routed"]["holdout_recall"]
               - want["routed"]["holdout_recall"]) <= TOL
    assert abs(got["filtered_10pct"]["recall"]
               - want["filtered_10pct"]["recall"]) <= TOL
    assert filtered and all(
        (ids[ids >= 0] % one.FILTER_EVERY == 0).all() for ids in filtered)
    assert got["filtered_10pct"]["pads"] == 0
    assert [r["B"] for r in got["latency"]["rows"]] == list(one.LATENCY_B)
    assert got["sustained_d8"]["recall"] == got["ops"][
        one.BLOCKS_K.index(got["routed"]["blocks_k"])]["recall"]
    mem = got["memory_gb"]
    assert mem["total"] == pytest.approx(
        sum(v for k, v in mem.items() if k != "total"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == [got]
    assert json.loads(out.read_text()) == got


@pytest.mark.parametrize("script,out", [
    ("bench_10m_torch.py", "BENCH_10M_TORCH.json"),
    ("dryrun_sharded_10m_torch.py", "BENCH_SHARDED_10M_TORCH.json")])
def test_main_without_cuda_exits_1(script, out):
    path = ROOT / out
    before = path.read_bytes() if path.exists() else None
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / script)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1
    assert res.stdout == ""
    assert "CUDA" in res.stderr
    assert (path.read_bytes() if path.exists() else None) == before
