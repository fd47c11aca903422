#!/usr/bin/env python
"""Headline benchmark of the PyTorch + CUDA port: query throughput at
recall@10 >= 0.95 on one GPU (the port's counterpart of bench.py).

    python3 bench_torch.py

Prints ONE JSON line to stdout:
  {"metric": ..., "value": <QPS at recall@10>=0.95 on 1M x 768-d>,
   "unit": "qps", "vs_baseline": <ours / reference, matched corpus>}

The engine serves a recall target with whichever index mode is fastest at
it. The headline runs the scan modes of vector_db_tpu_torch/ops/exact.py
over a 1M x 768 embedding-like corpus held on the card: the f32 exact scan
(the ground truth every other mode is measured against), the bf16 scan,
and the three- and two-phase block-select scans over a PCA-128 bf16
mirror, each per call and, for the three approximate modes, sustained at
queue depth 8. The HNSW detail (BENCH_N rows, then BENCH_REF_N rows, of
384-d) measures the classic beam's ef sweep, the wide beam and the
pool-free beam beside the f32 scan.

vs_baseline is a matched head-to-head: the best of the port's HNSW and
exact QPS on BENCH_REF_N rows over the reference's QPS (pure-Python HNSW
on the CPU) on the same corpus, read from the measurement cache; null
without a matching entry. The cache is never written.

Timing: 3 warm-ups, then the median of 3 reps, each with a distinct
perturbed query batch; every per-call rep ends in a device-to-host copy of
its distances, and the reps' distance signatures must differ. A sustained
row dispatches 8 perturbed batches back to back on the current stream and
synchronizes once inside its window.

Env knobs:
  BENCH_N          corpus for the HNSW detail numbers (default 100000)
  BENCH_HEADLINE_N corpus for the headline scan numbers (default 1000000)
  BENCH_REF_N      corpus size for the head-to-head (default 10000)
  BENCH_QUERIES    query batch (default 1000)
  BENCH_REF_CACHE  the reference-measurement cache (default .bench_ref.json)
  BENCH_DETAILS_TORCH  where the details go (default BENCH_DETAILS_TORCH.json)

Runs on the card only: without one it prints no result and exits 1.
Diagnostics go to stderr.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from vector_db_tpu_torch.datasets import embedding_like
from vector_db_tpu_torch.device import resolve_device
from vector_db_tpu_torch.index import hnsw_kernels as K
from vector_db_tpu_torch.index.hnsw import HNSW
from vector_db_tpu_torch.ops.distance import squared_norms
from vector_db_tpu_torch.ops.exact import (
    approx_search_tiled,
    block_select_search_2p,
    block_select_search_3p,
    exact_search_tiled,
)

DIM = 384               # the HNSW detail's and head-to-head's corpus width
HEADLINE_DIM = 768      # the headline corpus width
K_NN = 10
TARGET = 0.95
EF_SWEEP = [100, 150, 200, 300, 400, 600]
QUEUE_DEPTH = 8
PCA_DIMS = 128


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def recall_at_k(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    return float(
        np.mean([len(set(ids[i][:k]) & set(gt[i][:k])) / k
                 for i in range(len(gt))])
    )


def _host(t: torch.Tensor) -> np.ndarray:
    """A device-to-host copy: the sync that ends every per-call rep."""
    return t.cpu().numpy()


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


REP_TIMES: dict = {}  # label -> per-rep wall times


def timed_qps(run, q, n_q: int, reps: int = 3, warmups: int = 3,
              label: str | None = None):
    """Time ``run(query_batch) -> (result, sig)`` with warm-ups and varied
    inputs; (QPS of the median rep, the reps' results).

    ``sig`` is a float derived from the returned DISTANCES (top-k ids are
    stable under tiny query perturbations; distances are not). Raises
    unless the varied reps give distinct signatures: a run that returns
    stale results would otherwise time nothing.
    """
    for w in range(warmups):
        run(q * (1.0 + w * 1e-7))
    outs = []
    sigs = []
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        o, sig = run(q * (1.0 + (r + 1) * 1e-6))
        times.append(time.perf_counter() - t0)
        outs.append(o)
        sigs.append(float(sig))
    if len(set(sigs)) != len(sigs):
        raise AssertionError(
            "timed repetitions returned identical distance signatures: the "
            f"inputs were not varied or the results are stale ({sigs})")
    if label is not None:
        REP_TIMES[label] = [round(t, 5) for t in times]
    return n_q / float(np.median(times)), outs


def timed_pipelined(dispatch, q, n_q: int, depth: int = QUEUE_DEPTH,
                    reps: int = 3, label: str | None = None) -> float:
    """Sustained (queue-depth ``depth``) QPS of ``dispatch(batch) ->
    device result``, with no host sync between the calls.

    The ``depth`` perturbed batches are made before the window, dispatched
    back to back on the current stream (in order, one queue, as the TPU
    runs them), and synchronized once inside it. A call that syncs the
    host serializes the queue, and the row then reads as the per-call row;
    ``host_syncs`` lists where each mode syncs.
    """
    _sync(dispatch(q * (1.0 + 1e-7)))
    _sync(dispatch(q * (1.0 + 2e-7)))
    times = []
    for r in range(reps):
        vs = [q * (1.0 + (r * depth + i + 1) * 1e-6) for i in range(depth)]
        _sync(vs[-1])
        t0 = time.perf_counter()
        outs = [dispatch(v) for v in vs]
        _sync(outs[-1])
        times.append(time.perf_counter() - t0)
    if label is not None:
        REP_TIMES[label] = [round(t, 5) for t in times]
    return depth * n_q / float(np.median(times))


def host_syncs(dispatch, q) -> list:
    """Where one call of ``dispatch`` syncs the host, in the order met:
    for each synchronizing CUDA operation (``torch.cuda.set_sync_debug_mode``
    warns of it) the innermost line of this repo on the stack, and the
    library line that warned where that lies outside the repo. Empty on
    the CPU, where nothing is asked."""
    if not q.is_cuda:
        return []
    root = str(Path(__file__).resolve().parent) + os.sep
    found = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        frame = sys._getframe(1)
        while frame and not frame.f_code.co_filename.startswith(root):
            frame = frame.f_back
        site = (f"{frame.f_code.co_filename[len(root):]}:{frame.f_lineno}"
                if frame else "?")
        if not filename.startswith(root):
            site += f" ({filename.rpartition('site-packages/')[2]}:{lineno})"
        found.append(site)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        found.clear()   # what the switch itself warns of is no sync of a call
        try:
            dispatch(q)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def bench_ours(x: np.ndarray, q: np.ndarray, k: int, target: float,
               device) -> dict:
    """Build and measure the port's HNSW on ``x``: the exact scan, the
    classic ef sweep (to the first ef at ``target``), the wide beam and
    the pool-free beam."""
    n = x.shape[0]
    t0 = time.perf_counter()
    index = HNSW(M=16, ef_construction=200, rng=random.Random(42),
                 capacity=n, l_max=5, device=device)
    index.bulk_build(list(range(n)), x)
    _sync(index.graph.neighbors)
    build_s = time.perf_counter() - t0

    qd = torch.from_numpy(np.ascontiguousarray(q)).to(index.device)
    gt = _host(exact_search_tiled(qd, index._emb, index._has_emb, k)[1])

    def run_exact(qv):
        d, _ = exact_search_tiled(qv, index._emb, index._has_emb, k)
        d = _host(d).astype(np.float64)
        return d, d.sum()

    exact_qps, _ = timed_qps(run_exact, qd, len(q), label=f"exact_n{n}")

    chosen = None
    sweep = []
    for ef in EF_SWEEP:
        ms = 2 * ef + 16

        def run(qv):
            d, s = K.search_batch(
                index.graph, index._emb, index._has_emb, qv, None,
                M=16, l_max=5, ef=ef, k=k, max_steps=ms,
                use_filter=False, pool=ef, expand=4,
            )
            dd = _host(d).astype(np.float64)
            return _host(s), dd[dd < 1e37].sum()

        qps, outs = timed_qps(run, qd, len(q), warmups=2,
                              label=f"hnsw_n{n}_ef{ef}")
        rec = recall_at_k(outs[-1], gt, k)
        log(f"  ours n={n} ef={ef}: recall@{k}={rec:.3f} qps={qps:.0f}")
        chosen = {"ef": ef, "recall": rec, "qps": qps}
        sweep.append(dict(chosen))
        if rec >= target:
            break
    chosen["sweep"] = sweep
    chosen["build_s"] = build_s
    chosen["build_vps"] = n / build_s
    chosen["exact_qps"] = exact_qps

    # the wide beam (frontier-parallel traversal) at one operating point,
    # with the default (plain) pool merge
    index.enable_wide()
    ef_w = 512

    def run_wide(qv):
        d, s = index.search_batch_wide(_host(qv), k=k, ef=ef_w)
        dd = np.asarray(d, np.float64)
        return s, dd[dd < 1e37].sum()

    qps_w, outs_w = timed_qps(run_wide, qd, len(q), warmups=3,
                              label=f"hnsw_wide_n{n}")
    rec_w = recall_at_k(outs_w[-1], gt, k)
    log(f"  ours(wide) n={n} ef={ef_w}: recall@{k}={rec_w:.3f} "
        f"qps={qps_w:.0f}")
    chosen["wide"] = {"ef": ef_w, "recall": rec_w, "qps": qps_w}

    def run_beam(qv):
        d, s = index.search_batch_beam(_host(qv), k=k, frontier=64,
                                       steps=12)
        dd = np.asarray(d, np.float64)
        return s, dd[dd < 1e37].sum()

    qps_b, outs_b = timed_qps(run_beam, qd, len(q), warmups=3,
                              label=f"hnsw_beam_n{n}")
    rec_b = recall_at_k(outs_b[-1], gt, k)
    log(f"  ours(beam) n={n} F=64 T=12: recall@{k}={rec_b:.3f} "
        f"qps={qps_b:.0f}")
    chosen["beam"] = {"F": 64, "T": 12, "recall": rec_b, "qps": qps_b}
    return chosen


def bench_reference(x: np.ndarray, q: np.ndarray, cache_path: Path):
    """The reference HNSW's measurement at the same configuration, from
    the cache; None without an entry for this corpus."""
    key = f"n{x.shape[0]}_d{x.shape[1]}_M16_efc200_q{len(q)}"
    if cache_path.exists():
        cached = json.loads(cache_path.read_text())
        if cached.get("key") == key:
            log(f"  reference: cached measurement {cached}")
            return cached
    log(f"  reference: no cached measurement for {key} in {cache_path} "
        "-> vs_baseline null")
    return None


def bench_scan_headline(n: int, dim: int, n_q: int, k: int, device) -> dict:
    """Scan-mode QPS at the headline corpus shape: f32 exact (recall 1.0
    by construction), the bf16 scan and the two block-select scans, each
    measured against the f32 ground truth, and the sustained rows."""
    log(f"generating {n}x{dim} headline corpus...")
    data = embedding_like(n + n_q, dim, seed=1, intrinsic=64)
    x = torch.from_numpy(data[:n]).to(device)
    q = torch.from_numpy(data[n:]).to(device)
    del data
    valid = torch.ones((n,), dtype=torch.bool, device=device)
    x_bf16 = x.to(torch.bfloat16)
    x_sq = squared_norms(x)

    def d_exact(qv):
        return exact_search_tiled(qv, x, valid, k)[0]

    def run_exact(qv):
        d = _host(d_exact(qv)).astype(np.float64)
        return d, d.sum()

    gt = _host(exact_search_tiled(q, x, valid, k)[1])
    exact_qps, _ = timed_qps(run_exact, q, n_q, label=f"headline_exact_{n}")
    log(f"  exact f32 {n // 1000}k x {dim}d: {exact_qps:.0f} qps "
        "(recall 1.0)")

    def d_bf16(qv):
        return approx_search_tiled(qv, x_bf16, valid, k, x_sq=x_sq)

    def run_bf16(qv):
        d, i = d_bf16(qv)
        return _host(i), float(_host(d).astype(np.float64).sum())

    bf16_qps, outs = timed_qps(run_bf16, q, n_q, label=f"headline_bf16_{n}")
    bf16_recall = recall_at_k(outs[-1], gt, k)
    log(f"  bf16 scan {n // 1000}k x {dim}d: {bf16_qps:.0f} qps "
        f"(recall@{k}={bf16_recall:.4f} vs f32 exact)")

    # the PCA-128 bf16 mirror of the block-select scans: the covariance in
    # true f32, its eigenvectors in float64 on the host
    cov = _host(x.T @ x) / n
    _, vecs = np.linalg.eigh(cov.astype(np.float64))
    proj = torch.from_numpy(np.ascontiguousarray(
        vecs[:, ::-1][:, :PCA_DIMS].astype(np.float32))).to(device)
    ptab = (x @ proj).to(torch.bfloat16)

    def d_3p(qv):
        return block_select_search_3p(
            qv, ptab, qv @ proj, x_sq, x, valid, k,
            blocks_k=2 * k, rows_k=4 * k)

    def run_3p(qv):
        d, i = d_3p(qv)
        return _host(i), float(_host(d).astype(np.float64).sum())

    p3_qps, outs3 = timed_qps(run_3p, q, n_q, label=f"headline_3p_{n}")
    p3_recall = recall_at_k(outs3[-1], gt, k)
    log(f"  blocksel-3p {n // 1000}k x {dim}d: {p3_qps:.0f} qps "
        f"(recall@{k}={p3_recall:.4f} vs f32 exact)")

    def d_2p(qv):
        return block_select_search_2p(
            qv, ptab, qv @ proj, x_sq, x, valid, k, block=128, m=2,
            rows_k=8 * k)

    def run_2p(qv):
        d, i = d_2p(qv)
        return _host(i), float(_host(d).astype(np.float64).sum())

    p2_qps, outs2 = timed_qps(run_2p, q, n_q, label=f"headline_2p_{n}")
    p2_recall = recall_at_k(outs2[-1], gt, k)
    log(f"  blocksel-2p {n // 1000}k x {dim}d: {p2_qps:.0f} qps "
        f"(recall@{k}={p2_recall:.4f} vs f32 exact)")

    out = {
        "n": n, "dim": dim,
        "exact_f32": {"qps": exact_qps, "recall": 1.0},
        "bf16_scan": {"qps": bf16_qps, "recall": bf16_recall},
        "blocksel_3p": {"qps": p3_qps, "recall": p3_recall},
        "blocksel_2p": {"qps": p2_qps, "recall": p2_recall},
    }
    # sustained (queue-depth 8) rows: the recall is the per-call row's
    # (the same calls, the same selection)
    for mode, dispatch, recall in (("bf16_scan", d_bf16, bf16_recall),
                                   ("blocksel_3p", d_3p, p3_recall),
                                   ("blocksel_2p", d_2p, p2_recall)):
        qps = timed_pipelined(lambda qv: dispatch(qv)[0], q, n_q,
                              label=f"headline_{mode}_sust_{n}")
        log(f"  {mode} sustained(d{QUEUE_DEPTH}): {qps:.0f} qps")
        out[f"{mode}_sustained"] = {"qps": qps, "recall": recall,
                                    "queue_depth": QUEUE_DEPTH}
    out["host_syncs"] = {
        mode: host_syncs(dispatch, q)
        for mode, dispatch in (("exact_f32", d_exact), ("bf16_scan", d_bf16),
                               ("blocksel_3p", d_3p),
                               ("blocksel_2p", d_2p))}
    log(f"  host syncs in one call: {out['host_syncs']}")
    return out


MODE_NAMES = {
    "exact_f32": "f32 exact scan (l2_topk, 3xTF32)",
    "bf16_scan": "bf16 scan (l2_topk, exact selection)",
    "blocksel_3p": "3-phase block-select scan (block_min phase 1)",
    "blocksel_2p": "2-phase block-select scan (block_topm per-block top-m)",
}
MODE_NAMES.update({f"{m}_sustained": f"{name}, sustained queue-depth "
                   f"{QUEUE_DEPTH}" for m, name in list(MODE_NAMES.items())
                   if m != "exact_f32"})


def run(hnsw_n: int, headline_n: int, ref_n: int, n_q: int, device,
        cache_path: Path, details_path: Path) -> dict:
    """The whole benchmark on ``device``: the HNSW detail at ``hnsw_n``
    and ``ref_n`` rows, the reference from ``cache_path``, the headline at
    ``headline_n``. Writes the details to ``details_path``, prints the one
    result line and returns the details."""
    REP_TIMES.clear()
    device = torch.device(device)
    gpu = card()
    ref_q = min(n_q, 200)  # the reference's cached sweep used 200 queries
    log(f"bench_torch on {device} ({gpu}): hnsw_N={hnsw_n} "
        f"headline_N={headline_n} ref_N={ref_n} queries={n_q} "
        f"target recall@{K_NN}>={TARGET}")
    data = embedding_like(hnsw_n + n_q, DIM, seed=0)
    x, q = data[:hnsw_n], data[hnsw_n:]

    log("== ours: HNSW detail @ N ==")
    ours_hnsw = bench_ours(x, q, K_NN, TARGET, device)

    log("== ours @ head-to-head N (hnsw + exact) ==")
    ours_small = bench_ours(x[:ref_n], q, K_NN, TARGET, device)
    ours_small_best = max(ours_small["qps"], ours_small["exact_qps"])

    log("== reference @ head-to-head N ==")
    ref = bench_reference(x[:ref_n], q[:ref_q], Path(cache_path))

    log("== headline: scan modes @ headline corpus ==")
    headline = bench_scan_headline(headline_n, HEADLINE_DIM, n_q, K_NN,
                                   device)
    modes = {m: headline[m] for m in MODE_NAMES
             if headline[m]["recall"] >= TARGET}
    best_mode = max(modes, key=lambda m: modes[m]["qps"]) \
        if modes else "exact_f32"
    best = headline[best_mode]
    vs_baseline = (ours_small_best / ref["qps"]) if ref else None

    details = {
        "config": {"hnsw_N": hnsw_n, "headline_N": headline_n,
                   "ref_N": ref_n, "queries": n_q, "dim": DIM,
                   "headline_dim": HEADLINE_DIM, "k": K_NN,
                   "target_recall": TARGET, "M": 16, "ef_construction": 200},
        "device": {"card": gpu, "torch": torch.__version__,
                   "cuda": torch.version.cuda},
        "headline_1M_768": headline,
        "best_mode": best_mode,
        "ours_hnsw_detail": ours_hnsw,
        "ours_matched": {**ours_small, "best_mode_qps": ours_small_best},
        "reference": ref,
        "vs_baseline": vs_baseline,
        "rep_times_s": REP_TIMES,
    }
    Path(details_path).write_text(json.dumps(details, indent=2))
    log(json.dumps(details, indent=2))

    print(json.dumps({
        "metric": (
            f"QPS/GPU at recall@10>=0.95 on {headline_n:,} x "
            f"{HEADLINE_DIM}-d (best mode: {MODE_NAMES[best_mode]}, recall "
            f"{best['recall']:.4f} vs f32 exact; f32-exact recall-1.0 mode "
            f"= {headline['exact_f32']['qps']:.0f} qps); vs_baseline = "
            f"best-mode QPS ratio vs reference on matched "
            f"{ref_n // 1000}k corpus; card {gpu}"
        ),
        "value": round(best["qps"], 1),
        "unit": "qps",
        "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
    }), flush=True)
    return details


def main() -> int:
    # exact f32 products stay f32: the exact scans refuse TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        device = resolve_device("cuda")
    except RuntimeError as e:
        log(f"bench_torch: {e}")
        return 1
    run(hnsw_n=int(os.environ.get("BENCH_N", 100_000)),
        headline_n=int(os.environ.get("BENCH_HEADLINE_N", 1_000_000)),
        ref_n=int(os.environ.get("BENCH_REF_N", 10_000)),
        n_q=int(os.environ.get("BENCH_QUERIES", 1000)),
        device=device,
        cache_path=Path(os.environ.get("BENCH_REF_CACHE", ".bench_ref.json")),
        details_path=Path(os.environ.get("BENCH_DETAILS_TORCH",
                                         "BENCH_DETAILS_TORCH.json")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
