#!/usr/bin/env python
"""BASELINE config 2 on the PyTorch + CUDA port: 100k x 384-d, a
threshold-based flush to tiered storage, recall@10 against exact over an
ef_search sweep; scripts/bench_tiered.py's rows, sizes and seeds.

    python3 scripts/bench_tiered_torch.py

Env: BENCH_N (default 100000), BENCH_DIM (384), BENCH_FLUSH (1000),
BENCH_BATCH (5000), BENCH_OUT (BENCH_TIERED_TORCH.json at the repo root).

1. Streaming ingest through StorageService + IndexingService over
   MMapNodeStorage at the reference's field widths (content 10,240,
   metadata 5,120 characters), ``embedding_like(N + 1000, DIM, 0)`` in
   batches of BATCH: the first batch bulk-builds (an empty index and >= 4096
   nodes), the others stream in; past the flush threshold every batch
   schedules an asynchronous index flush. A flush counts when the batch
   leaves the index unmodified (the JAX script's test). Then
   ``force_save_index``, which waits for the flush writer.
2. Restart: a second StorageService + IndexingService on the same files
   must rescan the memmap and load the index checkpoint.
3. On the reloaded index: the exact top-10 (``search_batch_scan`` exact,
   ``l2_topk`` over the f32 table), then the wide beam
   (``search_batch_wide``) at ef 50 / 100 / 200 / 400 / 800 and the bf16
   scan (``l2_topk`` over the bf16 mirror, an exact rescore).

Each search row is timed as the JAX script's ``timed`` times it: 2 warm-up
calls on perturbed queries, then 3 reps, QPS from the median rep (host
clock); beside it the median rep's device ms from CUDA events and the
kernels the row launched. ``ingest.warm_batch_s_median`` is the median batch
time over the second half of the ingest; on the card it excludes the
allocator's and first shapes' costs only. Not carried over (relay
workarounds): the compile cache and the reasoning that the warm median
excludes XLA compiles.

The work directory (config.yaml, the memmaps: 6.45 GB of metadata file at
N = 100,000; the index npz) is a temporary directory, removed at the end
even on failure. Writes the results with the card's name and power limit
and prints them as one JSON line. Runs on the card only: without one it
prints no result and exits 1. Progress goes to stderr.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import (  # noqa: E402
    ROOT, card, cli, env_int, finish, header, launch_counts, launches_since,
    log, recall_of, saver, sync)
from vector_db_tpu_torch.datasets import embedding_like  # noqa: E402
from vector_db_tpu_torch.services.indexing_service import (  # noqa: E402
    IndexingService,
)
from vector_db_tpu_torch.services.storage_service import (  # noqa: E402
    StorageService,
)
from vector_db_tpu_torch.types import Node  # noqa: E402

N, DIM, FLUSH, BATCH = 100_000, 384, 1000, 5000
B, K = 1000, 10
EFS = (50, 100, 200, 400, 800)
WARM = 2    # scripts/bench_tiered.py's timed: 2 warm-up calls, 3 reps
REPS = 3


def timed(run, q: np.ndarray, n_q: int, cuda: bool):
    """scripts/bench_tiered.py's ``timed``: WARM calls on q * (1 + w 1e-7),
    then REPS on q * (1 + (r + 1) 1e-6), each returning host arrays.
    Returns (n_q over the median rep's host seconds, the median rep's
    device ms from CUDA events, None off the card)."""
    for w in range(WARM):
        sync(run(q * (1.0 + w * 1e-7)))
    secs, dev_ms = [], []
    for r in range(REPS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        sync(run(q * (1.0 + (r + 1) * 1e-6)))
        secs.append(time.perf_counter() - t0)
        if cuda:
            end.record()
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
    return (n_q / statistics.median(secs),
            statistics.median(dev_ms) if dev_ms else None)


def write_config(work: Path, dim: int, flush: int, capacity: int,
                 device) -> Path:
    """scripts/bench_tiered.py's config.yaml, on ``device``."""
    import yaml

    cfg = {
        "embedding": {"model": "fake", "dimension": dim},
        "device": torch.device(device).type,
        "index": {"M": 16, "ef_construction": 200,
                  "flush_threshold": flush, "type": "hnsw",
                  "wide": {"enabled": True, "min_size": 4096}},
        "vector_db": {"file_path": str(work / "vdb"), "dimension": dim,
                      "capacity": capacity},
    }
    path = work / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def ingest(svc, x: np.ndarray, n: int, batch: int, flush: int,
           results: dict) -> None:
    """Step 1: the streaming ingest, then ``force_save_index``."""
    flushes = 0
    batch_times = []
    before = launch_counts()
    t_ingest = time.perf_counter()
    for s in range(0, n, batch):
        e = min(n, s + batch)
        nodes = [Node(id=i, embedding=x[i], metadata={"b": s // batch})
                 for i in range(s, e)]
        t0 = time.perf_counter()
        svc.insert_nodes(nodes)
        dt = time.perf_counter() - t0
        batch_times.append(dt)
        # a flush happened iff the save cleared the modified flag
        flushed = not svc._index_modified and e >= flush
        flushes += int(flushed)
        log(f"ingest {e}/{n}: batch {dt:.1f}s"
            + (" [flushed]" if flushed else ""))
    ingest_s = time.perf_counter() - t_ingest
    t0 = time.perf_counter()
    svc.force_save_index()
    save_s = time.perf_counter() - t0
    warm = sorted(batch_times[len(batch_times) // 2:])
    warm_med = warm[len(warm) // 2]
    results["ingest"] = {
        "wall_s": ingest_s, "vps": n / ingest_s, "flushes": flushes,
        "warm_batch_s_median": warm_med,
        "warm_vps": batch / warm_med,
        "batch_s": [round(t, 2) for t in batch_times],
        "post_threshold_batches": max(0, (n - flush) // batch + 1),
        "force_save_s": save_s,
        "launches": launches_since(before),
    }
    log(f"ingest: {n / ingest_s:.0f} vps wall, "
        f"{batch / warm_med:.0f} vps warm, {flushes} threshold flushes")


def resume(work: Path, cfg_path: Path, dim: int, capacity: int, n: int,
           results: dict):
    """Step 2: the restart on the same files; the JAX script's three facts
    raise when they fail. Returns (storage service, indexing service)."""
    t0 = time.perf_counter()
    storage = StorageService(str(work / "vdb"), dim=dim, capacity=capacity)
    svc = IndexingService(storage=storage.storage,
                          config_path=str(cfg_path))
    resume_s = time.perf_counter() - t0
    if not svc.is_index_loaded():
        raise AssertionError("index checkpoint did not load")
    if storage.size() != n:
        raise AssertionError(f"memmap rescan found {storage.size()}")
    if svc.get_index_size() != n:
        raise AssertionError(f"the index holds {svc.get_index_size()}")
    results["resume"] = {"wall_s": resume_s,
                         "index_loaded": True, "storage_size": n}
    log(f"resume: {resume_s:.1f}s (rescan + checkpoint load)")
    return storage, svc


def sweep(svc, q: np.ndarray, cuda: bool, results: dict, efs=EFS) -> None:
    """Step 3: the exact truth, the ef sweep and the bf16 scan on the
    reloaded index."""
    index = svc.index
    b = q.shape[0]
    before = launch_counts()
    _, gt = index.search_batch_scan(q, K, mode="exact")
    results["truth_launches"] = launches_since(before)
    svc._maybe_enable_wide()
    rows = []
    for ef in efs:
        def run(v, ef=ef):
            return index.search_batch_wide(np.asarray(v), K, ef=ef)[0]

        before = launch_counts()
        _, ids = index.search_batch_wide(q, K, ef=ef)
        rec = recall_of(ids, gt, K)
        qps, dms = timed(run, q, b, cuda)
        rows.append({"ef": ef, "recall": rec, "qps": qps, "device_ms": dms,
                     "launches": launches_since(before)})
        log(f"ef={ef}: recall@10={rec:.4f} qps={qps:.0f}")
    results["ef_sweep"] = rows

    def run_scan(v):
        return index.search_batch_scan(np.asarray(v), K, mode="bf16")[0]

    before = launch_counts()
    _, sids = index.search_batch_scan(q, K, mode="bf16")
    qps, dms = timed(run_scan, q, b, cuda)
    results["bf16_scan"] = {"recall": recall_of(sids, gt, K), "qps": qps,
                            "device_ms": dms,
                            "launches": launches_since(before)}
    log(f"bf16 scan: {results['bf16_scan']}")


def run(n: int, device, out_path, dim: int = DIM, flush: int = FLUSH,
        batch: int = BATCH, efs=EFS, keep: dict | None = None) -> dict:
    """The three steps on ``device`` over ``n`` rows, in a temporary work
    directory. ``keep`` (a dict) receives the restarted services as
    ``storage`` and ``svc`` and the queries as ``q``; their files are gone
    once ``run`` returns, their tables on the device stay. Writes
    ``out_path``, prints the one result line and returns the results."""
    dev = torch.device(device)
    gpu = card()
    cuda = dev.type == "cuda"
    data = embedding_like(n + B, dim, 0)
    x, q = data[:n], np.ascontiguousarray(data[n:])
    results = {"N": n, "dim": dim, "flush_threshold": flush, "batch": batch,
               **header(dev, gpu)}
    capacity = n + batch
    with tempfile.TemporaryDirectory(prefix="bench_tiered_") as tmp:
        work = Path(tmp)
        cfg_path = write_config(work, dim, flush, capacity, dev)
        log(f"bench_tiered_torch on {dev} ({gpu}): {n} x {dim}, batches of "
            f"{batch}, work directory {work}")
        storage = StorageService(str(work / "vdb"), dim=dim,
                                 capacity=capacity)
        try:
            svc = IndexingService(storage=storage.storage,
                                  config_path=str(cfg_path))
            ingest(svc, x, n, batch, flush, results)
        finally:
            storage.close()
        saver(results, out_path)()
        storage2, svc2 = resume(work, cfg_path, dim, capacity, n, results)
        try:
            sweep(svc2, q, cuda, results, efs)
        finally:
            storage2.close()
    if keep is not None:
        keep.update(storage=storage2, svc=svc2, q=q)
    return finish(results, out_path)


def main() -> int:
    out = os.environ.get("BENCH_OUT", str(ROOT / "BENCH_TIERED_TORCH.json"))
    return cli("bench_tiered_torch", lambda dev: run(
        env_int("BENCH_N", N), dev, out, dim=env_int("BENCH_DIM", DIM),
        flush=env_int("BENCH_FLUSH", FLUSH),
        batch=env_int("BENCH_BATCH", BATCH)))


if __name__ == "__main__":
    sys.exit(main())
