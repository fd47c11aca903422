"""What the port's benchmark scripts (scripts/bench_{sift,pq,1m,latency,
insert,tiered,sharded,api}_torch.py) share: the log, the card's name, the
row timing of the JAX scripts' ``timed``, each row's kernel launches,
recall, the JSON file and the command-line entry.

Imports torch, numpy and ``vector_db_tpu_torch`` only.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from vector_db_tpu_torch.device import resolve_device  # noqa: E402
from vector_db_tpu_torch.ops.cuda import launch_counts  # noqa: E402,F401

WARM = 3      # warm-up calls of a timed row (the JAX scripts' timed)
REPS = 3      # timed calls of a row


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def sync(x) -> None:
    """Wait for the device work behind ``x`` (a tensor, a tuple of them or
    numpy, which is on the host already)."""
    if isinstance(x, (tuple, list)):
        x = x[0]
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _scaled(q, f: float):
    """``q`` (a tensor or a tuple of tensors) times ``f``."""
    if isinstance(q, tuple):
        return tuple(a * f for a in q)
    return q * f


def timed(run, q, n_q: int, reps: int = REPS):
    """The JAX scripts' ``timed``: WARM warm-up calls on q * (1 + w 1e-7),
    then ``reps`` calls on q * (1 + (r + 1) 1e-6), each ending in a sync
    (``run`` returns numpy, which has synced, or tensors). Returns (QPS of
    the reps on the host clock, the median device ms of a rep from CUDA
    events around it, None on the CPU). ``q`` may be a tuple of tensors,
    each perturbed."""
    for w in range(WARM):
        sync(run(_scaled(q, 1.0 + w * 1e-7)))
    cuda = torch.cuda.is_available() and (
        q[0] if isinstance(q, tuple) else q).is_cuda
    dev_ms = []
    t0 = time.perf_counter()
    for r in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = run(_scaled(q, 1.0 + (r + 1) * 1e-6))
        if cuda:
            end.record()
        sync(out)
        if cuda:
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
    qps = reps * n_q / (time.perf_counter() - t0)
    return qps, (statistics.median(dev_ms) if dev_ms else None)


def batch_ms(run, q: np.ndarray, cuda: bool, reps: int = 5):
    """scripts/bench_latency.py's small-batch timing: one warm-up call on
    q * (1 + 1e-7), then ``reps`` calls on q * (1 + (r + 1) 1e-6), each
    ending in a sync; the batch is numpy, so each call carries its copy to
    the device as the JAX script's do. Returns (median wall ms, median
    device ms from CUDA events when ``cuda``, else None)."""
    sync(run(_scaled(q, 1.0 + 1e-7)))
    walls, dev_ms = [], []
    for r in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = run(_scaled(q, 1.0 + (r + 1) * 1e-6))
        if cuda:
            end.record()
        sync(out)
        walls.append(time.perf_counter() - t0)
        if cuda:
            end.synchronize()
            dev_ms.append(start.elapsed_time(end))
    return (statistics.median(walls) * 1e3,
            statistics.median(dev_ms) if dev_ms else None)


def launches_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a ``launch_counts()``), by
    name, those launched at least once."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] > before[k]}


def host(x) -> np.ndarray:
    """A tensor or array as numpy (a device-to-host copy for a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def recall_of(ids, gt, k: int) -> float:
    """Mean share of each row's first k ids found in its truth row."""
    ids, gt = host(ids), host(gt)
    return float(np.mean([
        len(set(ids[i][:k].tolist()) & set(gt[i].tolist())) / k
        for i in range(len(gt))]))


def probe_ceiling(lists, n_rows: int, centroids: np.ndarray,
                  queries: np.ndarray, gt_ids: np.ndarray, n_probes):
    """The share of (query, true neighbour) pairs whose neighbour sits in a
    cell among the query's ``n_probe`` nearest centroids (the JAX scripts'
    host loops, vectorised): {n_probe: ceiling}. ``lists`` are the inverted
    lists of node ids, ids below ``n_rows``."""
    lens = np.array([len(c) for c in lists])
    nodes = (np.concatenate([np.asarray(c, np.int64) for c in lists])
             if lens.sum() else np.zeros(0, np.int64))
    cells = np.repeat(np.arange(len(lists)), lens)
    order = np.argsort(nodes, kind="stable")
    nodes, cells = nodes[order], cells[order]
    count = np.bincount(nodes, minlength=n_rows)
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    width = max(1, int(count.max(initial=0)))
    cell_of = np.full((n_rows, width), -1, np.int64)
    cell_of[nodes, np.arange(nodes.size) - start[nodes]] = cells
    cdh = ((centroids * centroids).sum(-1)[None, :]
           - 2.0 * (queries @ centroids.T))
    rank = np.argsort(cdh, axis=1)
    b = gt_ids.shape[0]
    out = {}
    for n_probe in n_probes:
        probed = np.zeros((b, len(lists) + 1), bool)
        probed[np.arange(b)[:, None], rank[:, :n_probe]] = True
        c = cell_of[gt_ids]                          # [B, K, width]
        hit = probed[np.arange(b)[:, None, None], c] & (c >= 0)
        out[n_probe] = float(hit.any(-1).mean())
    return out


SYNTHETIC = ("sift_like synthetic: anisotropic Gaussian mixture, "
             "log-normal cluster sizes (no egress for real SIFT1M)")


def sift_corpus(n: int, b: int, source: dict | None):
    """(rows, b queries, label) of the SIFT benchmarks: the caller's
    ``source`` (numpy ``x``, ``q``, optional ``data`` label), else the real
    TEXMEX files where SIFT1M_DIR points at them, else
    ``sift_like(n, 128, seed=0, queries=b)``."""
    from vector_db_tpu_torch.datasets import load_sift1m, sift_like

    if source is not None:
        return (np.asarray(source["x"], np.float32)[:n],
                np.asarray(source["q"], np.float32)[:b],
                source.get("data", SYNTHETIC))
    real = load_sift1m()
    if real is not None:
        base, queries, _ = real
        return (base[:n], queries[:b].astype(np.float32),
                "SIFT1M (real, TEXMEX files)")
    x, q = sift_like(n, dim=128, seed=0, queries=b)
    return x, q, SYNTHETIC


def header(dev: torch.device, gpu: str) -> dict:
    return {"card": gpu, "device": str(dev), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def saver(results: dict, out_path):
    """``save()``: write ``results`` to ``out_path`` as the JAX scripts
    write theirs after each section."""
    def save():
        Path(out_path).write_text(json.dumps(results, indent=2))
    return save


def finish(results: dict, out_path) -> dict:
    """Write the results and print them as the one line on stdout."""
    saver(results, out_path)()
    print(json.dumps(results), flush=True)
    return results


def cli(name: str, body) -> int:
    """The scripts' entry: exact f32 products (no TF32), the card or exit
    1 with no result, then ``body(device)``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        device = resolve_device("cuda")
    except RuntimeError as e:
        log(f"{name}: {e}")
        return 1
    body(device)
    return 0


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))
