#!/usr/bin/env python
"""Small-batch (latency-regime) serving benchmark at 1M vectors on the
PyTorch + CUDA port: scripts/bench_latency.py's rows, and the two rows that
scripts/exp_latency_addendum.py appends to its 1M x 768 section.

    python3 scripts/bench_latency_torch.py

Two halves, each at B in {1, 8, 64}: one warm-up call, then 5 calls on
perturbed batches, each ending in a sync or a copy to the host, the median
wall ms a batch and the QPS it gives. The batches are numpy, so every call
carries its copy to the card, as the JAX script's do.

- SIFT-shaped 1M x 128 (``sift_like(1M, 128, seed=0, queries=256)``),
  IvfIndex(4096) spill 2 with RP at 128 dims: ``exact_f32`` (``l2_topk``
  f32), ``bf16_scan`` (``l2_topk`` bf16), ``ivf_rp_probe8`` (n_probe 8,
  fetch 128). Each row also carries its recall@10 on the 256 queries
  against the exact f32 truth (the JAX script reports none here).
- 1M x 768 (``graph_1m_768``): the HNSW of scripts/bench_1m.py (the same
  corpus, seeds and build) with ``enable_wide(dims=128, seeds=4096)``:
  ``wide_ef512_ee``, ``wide_ef512``, ``wide_ef256_ee`` (``early_exit``) and
  ``bf16_scan``; then the addendum's ``wide_ef1280_f256_ee`` and
  ``blocksel_3p`` (PCA-128 bf16 mirror of the uncentred covariance,
  ``block_min``). Each mode's recall@10 on the 1000 queries at once.

``sift`` and ``graph`` hand ``run`` indexes built already (the spill-2
IvfIndex with RP of scripts/bench_sift_torch.py, the HNSW of
scripts/bench_1m_torch.py), so that a caller who ran those builds neither
twice; the SIFT half then runs on that corpus's first 256 queries.

Not carried over (relay and TPU-only workarounds): the compile cache;
the /tmp/wide1m_cache corpus and graph cache (a fresh build); the relay
dispatch floor (``relay_floor_ms``, ``addendum_floor_ms``) and the
``device_ms_est`` it gave, replaced by each row's ``device_ms`` from CUDA
events around the call.

Writes BENCH_LATENCY_TORCH.json with the card's name and power limit, and
prints it as one JSON line. Runs on the card only: without one it prints no
result and exits 1. Progress goes to stderr.
"""

from __future__ import annotations

import random
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import (  # noqa: E402
    ROOT, batch_ms, card, cli, finish, header, host, launch_counts,
    launches_since, log, recall_of, saver)
from vector_db_tpu_torch.datasets import (  # noqa: E402
    embedding_like,
    sift_like,
)
from vector_db_tpu_torch.index.hnsw import HNSW  # noqa: E402
from vector_db_tpu_torch.index.ivf import IvfIndex  # noqa: E402
from vector_db_tpu_torch.ops.distance import squared_norms  # noqa: E402
from vector_db_tpu_torch.ops.exact import (  # noqa: E402
    approx_search_tiled,
    block_select_search_3p,
    exact_search_tiled,
)

N, K = 1_000_000, 10
SIFT_Q = 256
GRAPH_DIM, GRAPH_B = 768, 1000
BATCHES = (1, 8, 64)
REPS = 5


def sift_index(n: int, dev, source: dict | None, k_cells: int):
    """bench_latency.py's SIFT half: (IvfIndex spill 2 with RP, queries)."""
    if source is None:
        x, q = sift_like(n, dim=128, seed=0, queries=SIFT_Q)
    else:
        x = np.asarray(source["x"], np.float32)[:n]
        q = np.asarray(source["q"], np.float32)
    ivf = IvfIndex(k=k_cells, device=dev)
    ivf.build_arrays(range(x.shape[0]), x, seed=0, iters=20, spill=2,
                     list_cap_alpha=2.0)
    ivf.enable_rp(dims=128)
    return ivf, q


def graph_index(n: int, dev, source: dict | None):
    """bench_1m.py's HNSW: (index, queries, the exact top-10 ids)."""
    if source is None:
        data = embedding_like(n + GRAPH_B, GRAPH_DIM, 0)
        x, q = data[:n], data[n:]
    else:
        x = np.asarray(source["x"], np.float32)[:n]
        q = np.ascontiguousarray(np.asarray(source["q"], np.float32))
    n = x.shape[0]
    index = HNSW(M=16, ef_construction=200, rng=random.Random(42),
                 capacity=n, l_max=5, device=dev)
    index.bulk_build(list(range(n)), x)
    tile = 31250 if n % 31250 == 0 else 25000
    gt = index._store.ids_of(host(exact_search_tiled(
        torch.from_numpy(q).to(dev), index._emb, index._has_emb, K,
        tile=tile)[1]))
    return index, q, gt


def to_dev(v: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)


def latency_rows(modes: dict, q_all: np.ndarray, rec: dict, cuda: bool,
                 say: str, batches=BATCHES, reps: int = REPS) -> list:
    rows = []
    for b in batches:
        q = q_all[:b]
        for name, run in modes.items():
            before = launch_counts()
            ms, dms = batch_ms(run, q, cuda, reps)
            row = {"batch": b, "mode": name, "ms_per_batch": ms,
                   "qps": b / (ms / 1e3), "recall": rec[name],
                   "device_ms": dms, "launches": launches_since(before)}
            log(f"{say} B={b} {name}: {ms:.2f} ms ({dms} device ms) "
                f"recall {rec[name]:.4f}")
            rows.append(row)
    return rows


def sift_half(dev, ivf, q_all, results, cuda, batches, reps) -> None:
    emb, has = ivf._emb, ivf._has_emb
    emb16 = emb.to(torch.bfloat16)
    x_sq = squared_norms(emb)
    modes = {
        "exact_f32": lambda v: exact_search_tiled(
            to_dev(v, dev), emb, has, K, tile=31250)[0],
        "bf16_scan": lambda v: approx_search_tiled(
            to_dev(v, dev), emb16, has, K, tile=131072, x_sq=x_sq)[0],
        "ivf_rp_probe8": lambda v: ivf.search_batch(
            v, n_probe=8, top_k=K, rp=True, fetch=128)[0],
    }
    qd = to_dev(q_all, dev)
    gt = ivf._store.ids_of(host(exact_search_tiled(qd, emb, has, K,
                                                   tile=31250)[1]))
    rec = {
        "exact_f32": 1.0,       # the truth itself
        "bf16_scan": recall_of(ivf._store.ids_of(host(approx_search_tiled(
            qd, emb16, has, K, tile=131072, x_sq=x_sq)[1])), gt, K),
        "ivf_rp_probe8": recall_of(ivf.search_batch(
            q_all, n_probe=8, top_k=K, rp=True, fetch=128)[1], gt, K)}
    results["rows"] = latency_rows(modes, q_all, rec, cuda, "1M128",
                                   batches, reps)


def graph_half(dev, index, q_all, gt, results, cuda, batches, reps) -> None:
    index.enable_wide(dims=128, seeds=4096)
    emb, has = index._emb, index._has_emb
    emb16 = emb.to(torch.bfloat16)
    x_sq = squared_norms(emb)
    # the addendum's PCA-128 bf16 mirror (the uncentred covariance)
    cov = host(emb.T @ emb).astype(np.float64) / emb.shape[0]
    _, vecs = np.linalg.eigh(cov)
    proj = to_dev(vecs[:, ::-1][:, :128].astype(np.float32), dev)
    ptab = (emb @ proj).to(torch.bfloat16)

    def wide(ef, frontier, steps, early_exit):
        return lambda v: index.search_batch_wide(
            v, K, ef=ef, frontier=frontier, steps=steps,
            early_exit=early_exit)

    def bf16(v):
        return approx_search_tiled(to_dev(v, dev), emb16, has, K,
                                   tile=125000, x_sq=x_sq)

    def three_phase(v):
        qv = to_dev(v, dev)
        return block_select_search_3p(qv, ptab, qv @ proj, x_sq, emb, has,
                                      K, blocks_k=2 * K, rows_k=4 * K)

    answers = {"wide_ef512_ee": wide(512, 64, 12, True),
               "wide_ef512": wide(512, 64, 12, False),
               "wide_ef256_ee": wide(256, 32, 12, True),
               "bf16_scan": bf16,
               "wide_ef1280_f256_ee": wide(1280, 256, 8, True),
               "blocksel_3p": three_phase}
    rec = {}
    for name, call in answers.items():
        ids = call(q_all)[1]
        if isinstance(ids, torch.Tensor):
            ids = index._store.ids_of(host(ids))
        rec[name] = recall_of(ids, gt, K)
        log(f"{name}: recall@10 = {rec[name]:.4f}")
    modes = {name: (lambda v, call=call: call(v)[0])
             for name, call in answers.items()}
    results["graph_1m_768"] = {
        "device_ms_from": "CUDA events around each call (in place of "
                          "relay_floor_ms and device_ms_est)",
        "addendum_modes": ["wide_ef1280_f256_ee", "blocksel_3p"],
        "rows": latency_rows(modes, q_all, rec, cuda, "1M768", batches,
                             reps)}


def run(n: int, device, out_path, sift: dict | None = None,
        graph: dict | None = None, sift_source: dict | None = None,
        graph_source: dict | None = None, k_cells: int = 4096,
        batches=BATCHES, reps: int = REPS) -> dict:
    """Both halves on ``device``. ``sift`` (``ivf``: an IvfIndex spill 2
    with RP at 128 dims, ``q``: queries) and ``graph`` (``hnsw``, ``q``,
    ``gt``: the exact top-10 ids) are indexes built already; without them
    the halves build their own over ``n`` rows (IvfIndex(``k_cells``)),
    from ``sift_source`` / ``graph_source`` (numpy ``x``, ``q``) when
    given. Writes ``out_path``,
    prints the one result line and returns the results."""
    dev = torch.device(device)
    gpu = card()
    cuda = dev.type == "cuda"
    if sift is None:
        ivf, q_sift = sift_index(n, dev, sift_source, k_cells)
    else:
        ivf, q_sift = sift["ivf"], sift["q"]
    q_sift = np.ascontiguousarray(np.asarray(q_sift, np.float32)[:SIFT_Q])
    n_sift = int(ivf._has_emb.sum())
    results = {"N": n_sift, "dim": 128, "k": K,
               "data": "sift_like (see bench_sift_torch.py)",
               "sift_queries": int(q_sift.shape[0]), **header(dev, gpu)}
    log(f"bench_latency_torch on {dev} ({gpu}): SIFT half, {n_sift} rows")
    sift_half(dev, ivf, q_sift, results, cuda, batches, reps)
    saver(results, out_path)()
    del ivf
    if graph is None:
        index, q_all, gt = graph_index(n, dev, graph_source)
    else:
        index, q_all, gt = graph["hnsw"], graph["q"], graph["gt"]
    log(f"1M x 768 half: {index.size} rows, {len(q_all)} queries")
    graph_half(dev, index, np.ascontiguousarray(q_all, np.float32), gt,
               results, cuda, batches, reps)
    return finish(results, out_path)


def main() -> int:
    return cli("bench_latency_torch", lambda dev: run(
        N, dev, ROOT / "BENCH_LATENCY_TORCH.json"))


if __name__ == "__main__":
    sys.exit(main())
