"""bench_torch.py (the port's headline benchmark) against bench.py on the
same numpy inputs, at tiny sizes on the CPU: the corpora bit-equal, the
headline's f32 ground truth and each mode's recall, the HNSW detail's ef
sweep, wide and beam rows; then a rehearsal of ``run`` with the card's name
stubbed (one JSON line, the details file, vs_baseline from the cache), the
signature check of ``timed_qps``, where ``host_syncs`` reports a sync, and
``main`` without a card.

Tolerances: the f32 ground truths' distances rtol 1e-5, atol 1e-5 and ids
equal except between tied values; recalls of the exact and block-select
modes within 0.01 of bench.py's (one id in 640 is 0.0016), the bf16 row
held from below only (port >= JAX - 0.02: JAX selects with approx_min_k,
the port exactly); the HNSW rows within 0.02 (the two packages build their
graphs with different k-means draws).
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import bench_torch
from tests.torch_parity import assert_topk_parity
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu import datasets as jax_datasets
from vector_db_tpu_torch import datasets as port_datasets

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
EXACT_TOL = 0.01
BF16_SLACK = 0.02
HNSW_TOL = 0.02
HEADLINE = dict(n=8192, dim=128, n_q=64, k=10)


def _once(run, q, n_q, reps=3, warmups=3, label=None):
    """timed_qps at one call: the recall comes from the last rep's result,
    and a time on the CPU measures nothing here."""
    o, _ = run(q)
    return 1.0, [o]


def _once_piped(dispatch, q, n_q, depth=8, reps=3, label=None):
    dispatch(q)
    return 1.0


def _recording(mp, module, log):
    """Record every recall_at_k that ``module`` computes."""
    real = module.recall_at_k

    def rec(ids, gt, k):
        r = real(ids, gt, k)
        log.append(r)
        return r
    mp.setattr(module, "recall_at_k", rec)


@pytest.mark.parametrize("n,dim,seed", [(1064, 384, 0), (8256, 128, 1)])
def test_corpora_bit_equal(n, dim, seed):
    np.testing.assert_array_equal(
        port_datasets.embedding_like(n, dim, seed=seed, intrinsic=64),
        jax_datasets.embedding_like(n, dim, seed=seed, intrinsic=64))


def test_headline_matches_bench_py(monkeypatch):
    for mod in (bench, bench_torch):
        monkeypatch.setattr(mod, "timed_qps", _once)
        monkeypatch.setattr(mod, "timed_pipelined", _once_piped)
    n, dim, n_q, k = (HEADLINE[key] for key in ("n", "dim", "n_q", "k"))
    want = bench.bench_scan_headline(n, dim, n_q, k)
    got = bench_torch.bench_scan_headline(n, dim, n_q, k, "cpu")

    # the f32 ground truths: the same ids per query, ties aside
    import jax.numpy as jnp
    from vector_db_tpu.ops.exact import exact_search_tiled as jax_exact
    from vector_db_tpu_torch.ops.exact import exact_search_tiled

    data = port_datasets.embedding_like(n + n_q, dim, seed=1, intrinsic=64)
    x, q = data[:n], data[n:]
    jd, ji = jax_exact(jnp.asarray(q), jnp.asarray(x),
                       jnp.ones((n,), bool), k, tile=25000)
    pd, pi = exact_search_tiled(torch.from_numpy(q), torch.from_numpy(x),
                                torch.ones(n, dtype=torch.bool), k)
    assert_topk_parity(pd, pi, np.asarray(jd), np.asarray(ji))

    assert got["exact_f32"]["recall"] == want["exact_f32"]["recall"] == 1.0
    assert got["bf16_scan"]["recall"] >= \
        want["bf16_scan"]["recall"] - BF16_SLACK
    for mode in ("blocksel_3p", "blocksel_2p"):
        assert abs(got[mode]["recall"] - want[mode]["recall"]) <= EXACT_TOL, \
            (mode, got[mode], want[mode])
    for mode in ("bf16_scan", "blocksel_3p", "blocksel_2p"):
        row = got[f"{mode}_sustained"]
        assert row["recall"] == got[mode]["recall"]
        assert row["queue_depth"] == 8 and row["qps"] > 0
    assert set(got["host_syncs"]) == {"exact_f32", "bf16_scan",
                                      "blocksel_3p", "blocksel_2p"}


def test_hnsw_detail_matches_bench_py(monkeypatch):
    data = port_datasets.embedding_like(3000 + 64, 32, seed=0)
    x, q = data[:3000], data[3000:]
    recalls = {}
    for name, mod in (("jax", bench), ("port", bench_torch)):
        monkeypatch.setattr(mod, "timed_qps", _once)
        recalls[name] = []
        _recording(monkeypatch, mod, recalls[name])
    want = bench.bench_ours(x, q, 10, 0.95)
    got = bench_torch.bench_ours(x, q, 10, 0.95, "cpu")

    # recall_at_k runs once per swept ef, then for wide and beam
    sweeps = {name: r[:-2] for name, r in recalls.items()}
    for name, sweep in sweeps.items():
        # the rule: stop at the first ef that reaches the target
        assert all(r < 0.95 for r in sweep[:-1]), (name, sweep)
        assert sweep[-1] >= 0.95 or len(sweep) == len(bench.EF_SWEEP)
    assert len(sweeps["port"]) == len(sweeps["jax"]), sweeps
    assert got["ef"] == want["ef"]
    assert [s["recall"] for s in got["sweep"]] == sweeps["port"]
    np.testing.assert_allclose(sweeps["port"], sweeps["jax"], atol=HNSW_TOL)
    for row in ("wide", "beam"):
        assert abs(got[row]["recall"] - want[row]["recall"]) <= HNSW_TOL, \
            (row, got[row], want[row])
    assert got["exact_qps"] > 0 and got["build_s"] > 0


REHEARSAL = dict(hnsw_n=1200, headline_n=2048, ref_n=1000, n_q=8)


@pytest.mark.parametrize("cached", [True, False])
def test_run_rehearsal(monkeypatch, capsys, tmp_path, cached):
    monkeypatch.setattr(bench_torch, "card", lambda: "Rehearsal GPU, 700 W")
    cache = tmp_path / "ref.json"
    key = (f"n{REHEARSAL['ref_n']}_d384_M16_efc200_q"
           f"{min(REHEARSAL['n_q'], 200)}")
    if cached:
        cache.write_text(json.dumps({"key": key, "qps": 50.0}))
    details_path = tmp_path / "details.json"
    jax_details = ROOT / "BENCH_DETAILS.json"
    before = jax_details.read_bytes()

    details = bench_torch.run(**REHEARSAL, device="cpu", cache_path=cache,
                              details_path=details_path)

    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}
    assert out["unit"] == "qps" and out["value"] > 0
    assert "Rehearsal GPU, 700 W" in out["metric"]
    best = details["headline_1M_768"][details["best_mode"]]
    assert best["recall"] >= 0.95
    assert out["value"] == round(best["qps"], 1)
    small = details["ours_matched"]
    if cached:
        assert out["vs_baseline"] == round(
            max(small["qps"], small["exact_qps"]) / 50.0, 2)
    else:
        assert out["vs_baseline"] is None and details["reference"] is None
    assert json.loads(details_path.read_text()) == details
    assert details["device"]["card"] == "Rehearsal GPU, 700 W"
    assert jax_details.read_bytes() == before
    for label in ("headline_exact_2048", "headline_bf16_scan_sust_2048",
                  "hnsw_wide_n1200", "hnsw_beam_n1000"):
        assert len(details["rep_times_s"][label]) == 3, label


def test_timed_qps_rejects_identical_signatures():
    q = torch.ones(4, 3)
    with pytest.raises(AssertionError, match="identical distance"):
        bench_torch.timed_qps(lambda qv: (None, 1.0), q, 4)
    qps, outs = bench_torch.timed_qps(
        lambda qv: (qv, float(qv.double().sum())), q, 4, label="varied")
    assert qps > 0 and len(outs) == 3
    assert len(bench_torch.REP_TIMES.pop("varied")) == 3


def test_main_without_cuda_exits_nonzero():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def _synchronizing_op():
    warnings.warn("called a synchronizing CUDA operation")
    return 0


def test_host_syncs_names_the_repo_line(monkeypatch):
    """On a card, each synchronizing operation that the sync debug mode
    warns of is reported at the innermost line of the repo on the stack;
    other warnings are not. (The debug mode itself needs a card: a fake
    CUDA batch and a warning stand in for them here.)"""
    modes = []

    def set_mode(mode):
        modes.append(mode)
        if mode == "warn":  # as the card does when the mode goes on
            _synchronizing_op()
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)

    class CudaBatch:
        is_cuda = True

    def dispatch(q):
        warnings.warn("an unrelated warning")
        return _synchronizing_op()

    line = _synchronizing_op.__code__.co_firstlineno + 1
    assert bench_torch.host_syncs(dispatch, CudaBatch()) == [
        f"tests/test_torch_bench.py:{line}"]
    assert modes == ["warn", "default"]
    assert bench_torch.host_syncs(dispatch, torch.ones(1)) == []
