#!/usr/bin/env python
"""Sharded scale-out on the PyTorch + CUDA port: scripts/bench_sharded.py's
rows, sizes and seeds, over an 8-shard mesh.

    python3 scripts/bench_sharded_torch.py

The mesh is ``make_mesh(devices=[card] * 8)``: eight shards, one per entry,
all on the one card (a list may name one device more than once); the JAX
script runs on an 8-device virtual CPU mesh. ``platform`` names the card
and the number of distinct devices.

- ``ShardedFlatIndex`` at 4,000,000 x 64 (``rng.standard_normal``, seed 0),
  ingested in steps of 500,000 (each id routed on the host); one warm-up
  search, then one timed search of 64 queries (``l2_topk`` on each shard,
  the merge on the first device), held against a numpy brute force over
  the same rows (independent of the code under test). The kernels of
  both searches are counted, each on its own.
- ``ShardedHNSW(M=12, ef_construction=80)`` at 262,144 x 64: the bulk
  build (``knn_exact`` on ``l2_topk`` per shard), recall@10 at ef 120
  against a numpy exact top-10 of 32 queries, one timed search, a
  streamed insert of 1,024 rows (the first four must be their own top-1),
  ``delete_batch`` of 256 with edge unlink (no deleted id may return), and
  a search under a 25 % filter set (every hit in the set; recall against
  the masked numpy truth).

The JAX file's keys stay, ``search_qps_cpu`` and ``build_vps_cpu``
included: on the port they hold the card's figures. Every time is the host
clock around a call and a sync of the mesh's devices, so a call that only
queues device work (``delete_batch``, the ingest) is timed to the end of
that work. Each section also carries the kernels it launched. Not carried over: the XLA flag that makes 8 virtual CPU devices.

Writes BENCH_SHARDED_TORCH.json with the card's name and power limit, and
prints it as one JSON line. Runs on the card only: without one it prints no
result and exits 1. Progress goes to stderr.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import (  # noqa: E402
    ROOT, card, cli, finish, header, launch_counts, launches_since, log,
    saver)
from vector_db_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from vector_db_tpu_torch.parallel.sharded import (  # noqa: E402
    ShardedFlatIndex,
    ShardedHNSW,
)

SHARDS = 8
N_FLAT, DIM, B, K = 4_000_000, 64, 64, 10
STEP = 500_000
N_HNSW, Q_HNSW = 262_144, 32
N_EXTRA = 1024


def _recall(got: np.ndarray, truth: np.ndarray, k: int) -> float:
    return float(np.mean([len(set(got[i].tolist()) & set(truth[i].tolist()))
                          / k for i in range(len(truth))]))


def brute_force(x: np.ndarray, q: np.ndarray, k: int, step: int
                ) -> np.ndarray:
    """scripts/bench_sharded.py's numpy ground truth: a running top-k over
    ``step``-row blocks of x."""
    b = q.shape[0]
    best_d = np.full((b, k), np.inf)
    best_i = np.full((b, k), -1, np.int64)
    for s in range(0, x.shape[0], step):
        blk = x[s:s + step]
        d = ((q * q).sum(1)[:, None] - 2 * q @ blk.T
             + (blk * blk).sum(1)[None, :])
        part = np.argpartition(d, k, axis=1)[:, :k]
        pd = np.take_along_axis(d, part, axis=1)
        cd = np.concatenate([best_d, pd], axis=1)
        ci = np.concatenate([best_i, part + s], axis=1)
        sel = np.argsort(cd, axis=1)[:, :k]
        best_d = np.take_along_axis(cd, sel, axis=1)
        best_i = np.take_along_axis(ci, sel, axis=1)
    return best_i


def _sync(mesh) -> None:
    """Wait for the work queued on every CUDA device of ``mesh``."""
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def flat_section(mesh, rng, n: int, step: int, keep) -> dict:
    log(f"flat: generating {n}x{DIM}...")
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    q = rng.standard_normal((B, DIM)).astype(np.float32)
    flat = ShardedFlatIndex(mesh=mesh, dim=DIM,
                            capacity_per_shard=n // SHARDS)
    t0 = time.perf_counter()
    for s in range(0, n, step):
        flat.insert(range(s, min(n, s + step)), x[s:s + step])
    _sync(mesh)
    ingest_s = time.perf_counter() - t0
    log(f"flat ingest: {ingest_s:.1f}s ({n / ingest_s:.0f} vec/s)")

    before = launch_counts()
    flat.search_batch(q, k=K)      # warm-up
    warm_launched = launches_since(before)
    before = launch_counts()
    t0 = time.perf_counter()
    _, ids1 = flat.search_batch(q * (1 + 1e-6), k=K)
    _sync(mesh)
    search_s = time.perf_counter() - t0
    launched = launches_since(before)
    log(f"flat sharded search: {B / search_s:.1f} qps")
    log("flat: brute-force ground truth...")
    rec = _recall(ids1, brute_force(x, q, K, step), K)
    log(f"flat sharded vs brute force: recall@{K} = {rec:.4f}")
    if keep is not None:
        keep.update(flat=flat, flat_q=q)
    return {"n": n, "dim": DIM, "ingest_s": ingest_s,
            "ingest_vps": n / ingest_s, "search_qps_cpu": B / search_s,
            "search_s": search_s, "recall_vs_bruteforce": rec,
            "warm_launches": warm_launched, "search_launches": launched}


def hnsw_section(mesh, rng, n2: int) -> dict:
    log(f"hnsw: generating {n2}x{DIM}...")
    x2 = rng.standard_normal((n2, DIM)).astype(np.float32)
    q2 = rng.standard_normal((Q_HNSW, DIM)).astype(np.float32)
    idx = ShardedHNSW(M=12, ef_construction=80, mesh=mesh, dim=DIM,
                      capacity_per_shard=n2 // SHARDS + 1024)
    before = launch_counts()
    t0 = time.perf_counter()
    idx.bulk_build(range(n2), x2)
    _sync(mesh)
    build_s = time.perf_counter() - t0
    build_launches = launches_since(before)
    log(f"hnsw bulk_build: {build_s:.1f}s ({n2 / build_s:.0f} vec/s)")

    d = (q2 * q2).sum(1)[:, None] - 2 * q2 @ x2.T + (x2 * x2).sum(1)[None, :]
    gt2 = np.argsort(d, axis=1)[:, :10]
    before = launch_counts()
    _, ids2 = idx.search_batch(q2, k=10, ef=120)
    rec = _recall(ids2, gt2, 10)
    t0 = time.perf_counter()
    idx.search_batch(q2 * (1 + 1e-6), k=10, ef=120)
    _sync(mesh)
    qps = Q_HNSW / (time.perf_counter() - t0)
    search_launches = launches_since(before)
    log(f"hnsw sharded search: recall@10={rec:.3f} {qps:.1f} qps")

    extra = rng.standard_normal((N_EXTRA, DIM)).astype(np.float32)
    before = launch_counts()
    t0 = time.perf_counter()
    idx.insert(range(n2, n2 + N_EXTRA), extra)
    _sync(mesh)
    ins_s = time.perf_counter() - t0
    insert_launches = launches_since(before)
    _, eids = idx.search_batch(extra[:4], k=1, ef=80)
    if list(eids[:, 0]) != [n2, n2 + 1, n2 + 2, n2 + 3]:
        raise AssertionError(f"inserted rows not their own top-1: "
                             f"{eids[:, 0].tolist()}")

    victims = list(range(0, 4096, 16))
    t0 = time.perf_counter()
    idx.delete_batch(victims)
    _sync(mesh)
    del_s = time.perf_counter() - t0
    _, ids3 = idx.search_batch(x2[victims[:8]], k=5, ef=80)
    if set(victims) & set(ids3.ravel().tolist()):
        raise AssertionError("a deleted id came back")
    log(f"hnsw insert {N_EXTRA}: {ins_s:.1f}s; delete {len(victims)}: "
        f"{del_s:.3f}s")

    # 25 % random filter set: the subset contract and recall against the
    # masked brute force
    fset = set(int(i) for i in rng.choice(n2, size=n2 // 4, replace=False))
    fset -= set(victims)
    before = launch_counts()
    _, fids = idx.search_batch(q2, k=10, ef=160, filter_ids=fset)
    filtered_launches = launches_since(before)
    alf = np.asarray(sorted(fset))
    df = ((q2[:, None] - x2[alf][None]) ** 2).sum(-1)
    gtf = alf[np.argsort(df, axis=1)[:, :10]]
    if not all(int(v) in fset for row in fids for v in row if v >= 0):
        raise AssertionError("a filtered hit outside the filter set")
    rec_f = _recall(fids, gtf, 10)
    log(f"hnsw sharded filtered search (25%): recall@10={rec_f:.3f}")
    return {"n": n2, "dim": DIM, "bulk_build_s": build_s,
            "build_vps_cpu": n2 / build_s, "recall_at_10_ef120": rec,
            "search_qps_cpu": qps, "insert_1024_s": ins_s,
            "delete_256_s": del_s, "filtered_recall_at_10_ef160": rec_f,
            "filtered_selectivity": 0.25,
            "build_launches": build_launches,
            "search_launches": search_launches,
            "insert_launches": insert_launches,
            "filtered_launches": filtered_launches}


def run(n: int, device, out_path, n_hnsw: int = N_HNSW, step: int = STEP,
        keep: dict | None = None) -> dict:
    """Both sections on an 8-shard mesh over ``device`` (each entry the
    same device), the flat index over ``n`` rows. ``keep`` (a dict)
    receives the flat index as ``flat`` and its queries as ``flat_q``.
    Writes ``out_path``, prints the one result line and returns the
    results."""
    dev = torch.device(device)
    gpu = card()
    mesh = make_mesh(devices=[dev] * SHARDS)
    distinct = len(set(mesh.devices))
    rng = np.random.default_rng(0)
    results = {"mesh_devices": mesh.size,
               "platform": f"{gpu}: {mesh.size} shards on {distinct} "
                           f"device(s) ({dev})",
               **header(dev, gpu)}
    log(f"bench_sharded_torch: {results['platform']}")
    results["flat_4m"] = flat_section(mesh, rng, n, step, keep)
    saver(results, out_path)()
    results["hnsw_256k"] = hnsw_section(mesh, rng, n_hnsw)
    return finish(results, out_path)


def main() -> int:
    return cli("bench_sharded_torch", lambda dev: run(
        N_FLAT, dev, ROOT / "BENCH_SHARDED_TORCH.json"))


if __name__ == "__main__":
    sys.exit(main())
