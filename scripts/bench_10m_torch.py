#!/usr/bin/env python
"""10M x 768 on one GPU (BASELINE config 5 scale): the two-stage compressed
search of scripts/bench_10m.py on the PyTorch + CUDA port, with recall
measured against exact ground truth.

    python3 scripts/bench_10m_torch.py     # BENCH10M_N rows, default 10M

The corpus is 30.7 GB of f32, so it never exists at once: it is generated
on the card chunk by chunk (a rank-64 mixture plus isotropic noise,
L2-normalised, from one seeded generator), and each chunk, in one pass,
(a) folds into the exact running top-k of the queries on ``l2_topk``'s f32
table (the ground truth, plain and under a 10 % filter), (b) writes its
rows of the projected bf16 mirror ``x @ proj`` with their f32 norms, and
(c) writes its int8 full-width mirror with per-row scales. The search:

- stage 1: the per-128-row block minima of ``||x||^2 - 2 q_p . x_p`` over
  the mirror (``block_min_scan``, one launch for all queries), then the
  ``blocks_k`` smallest blocks chosen exactly (``torch.topk``);
- stage 2, per slice of QS queries: the chosen blocks' int8 rows widened
  and dotted with bf16(q) in f32, scored ``||x||^2 - 2 s q.x_i8 + ||q||^2``
  and cut to the top 10.

A filter (ids % 10 == 0) folds into the norms: a filtered-out row scores
2e38 in both stages.

Differences from scripts/bench_10m.py: the norms beside the mirror are f32
(the JAX augmented row carries them in bf16); the blocks are chosen exactly
(JAX: ``approx_min_k``); stage 2 widens to f32 (the products of bf16(q)
and int8 values are exact in f32 either way); the relay probe behind
``rtt_floor_ms`` is gone and the latency rows carry the device time from
CUDA events.

Writes BENCH_10M_TORCH.json (with the card's name and power limit) and
prints it as one JSON line. Runs on the card only: without one it prints
no result and exits 1. Diagnostics go to stderr.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vector_db_tpu_torch.device import resolve_device  # noqa: E402
from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan  # noqa: E402
from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk  # noqa: E402
from vector_db_tpu_torch.ops.distance import (  # noqa: E402
    BIG,
    BIG_THRESH,
    PAD_ROW,
    squared_norms,
)
from vector_db_tpu_torch.ops.topk import merge_top_k  # noqa: E402

DIM, DP, B, K = 768, 120, 1000, 10
QS = 100                # queries per stage-2 slice: bounds the gather
CHUNK = 131072
INTRINSIC = 64          # rank of the corpus's mixture
NOISE = 0.12
SEED = 7
BLOCK = 128             # rows per block of stage 1
BLOCKS_K = (8, 16, 32, 64)
TARGET = 0.95           # the routed point's calibration target
REPS = 3
QUEUE_DEPTH = 8
LATENCY_B = (1, 8)
LATENCY_REPS = 20
FILTER_EVERY = 10       # the filter keeps ids % 10 == 0: 10 % selectivity

Source = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
               Callable[[int], torch.Tensor]]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def gen(g: torch.Generator, mix: torch.Tensor, n: int) -> torch.Tensor:
    """n rows ``z @ mix + NOISE * noise``, L2-normalised (f32, mix's
    device), drawn from ``g``."""
    z = torch.randn(n, mix.shape[0], generator=g, device=mix.device)
    x = z @ mix + NOISE * torch.randn(n, mix.shape[1], generator=g,
                                      device=mix.device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def own_source(dev: torch.device, seed: int, dp: int, b: int,
               chunk: int) -> Source:
    """(mix, extra, queries, rows_of) from one generator on ``dev`` seeded
    ``seed``; ``rows_of(ci)`` draws chunk ci's rows, so the chunks are
    drawn in order, each once."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mix = torch.randn(INTRINSIC, DIM, generator=g, device=dev)
    extra = torch.randn(DIM, dp, generator=g, device=dev)
    queries = gen(g, mix, b)
    return mix, extra, queries, lambda ci: gen(g, mix, chunk)


def to_device(a, dev: torch.device) -> torch.Tensor:
    """A copy of numpy ``a`` as f32 on ``dev``."""
    return torch.from_numpy(np.array(a, np.float32)).to(dev)


def given_source(source: dict, dev: torch.device) -> Source:
    """A caller's numpy ``mix``, ``extra``, ``queries`` and ``chunks``
    (chunk ci's rows at ``chunks[ci]``), on ``dev``."""
    return (to_device(source["mix"], dev), to_device(source["extra"], dev),
            to_device(source["queries"], dev),
            lambda ci: to_device(source["chunks"][ci], dev))


def projection(mix: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    """[DIM, dp]: the mixture's row space (its right-singular vectors)
    extended by QR with ``extra``'s columns to an orthonormal basis. SVD and
    QR signs may differ between libraries; queries and rows share the
    projection, so the search does not see them."""
    _, _, vt = torch.linalg.svd(mix, full_matrices=False)
    basis, _ = torch.linalg.qr(torch.cat([vt.T, extra], dim=1))
    return basis[:, :extra.shape[1]].contiguous()


@dataclass
class Tables:
    mirror: torch.Tensor     # bf16|f32 [N_pad, dp]: x @ proj
    xsq_eff: torch.Tensor    # f32 [N_pad]: ||x||^2, PAD_ROW past N
    xi8: torch.Tensor        # int8 [N_pad, DIM]: round(x / scale)
    scales: torch.Tensor     # f32 [N_pad]: max(max |x|, 1e-9) / 127
    truth: tuple             # (f32, int32) [B, K]: exact top-k
    truth_filtered: tuple    # the same over ids % FILTER_EVERY == 0
    rerank_dtype: torch.dtype  # the query's rounding in stage 2

    def nbytes(self) -> dict:
        sizes = {name: getattr(self, name).nbytes / 1e9
                 for name in ("mirror", "xsq_eff", "xi8", "scales")}
        sizes["total"] = sum(sizes.values())
        return sizes


def build_tables(queries: torch.Tensor, proj: torch.Tensor,
                 rows_of: Callable[[int], torch.Tensor], n: int, chunk: int,
                 mirror_dtype: torch.dtype,
                 rerank_dtype: torch.dtype = torch.bfloat16) -> Tables:
    """One pass over the ceil(n / chunk) chunks (rows past n are drawn and
    marked invalid, as the JAX padding is); each chunk is freed after its
    pass. The truths fold through ``l2_topk`` on the chunk's f32 rows."""
    dev = queries.device
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk
    mirror = torch.empty((n_pad, proj.shape[1]), dtype=mirror_dtype,
                         device=dev)
    xsq_eff = torch.empty(n_pad, device=dev)
    xi8 = torch.empty((n_pad, DIM), dtype=torch.int8, device=dev)
    scales = torch.empty(n_pad, device=dev)
    folds = {}
    for name in ("all", "filtered"):
        folds[name] = (
            torch.full((queries.shape[0], K), BIG, device=dev),
            torch.full((queries.shape[0], K), -1, dtype=torch.int32,
                       device=dev))
    for ci in range(n_chunks):
        s = ci * chunk
        x = rows_of(ci)
        gid = torch.arange(s, s + chunk, device=dev)
        row_ok = gid < n
        x_sq = squared_norms(x)
        for name, valid in (("all", row_ok),
                            ("filtered", row_ok & (gid % FILTER_EVERY == 0))):
            d, i = l2_topk(queries, x, valid, K, x_sq=x_sq)
            folds[name] = merge_top_k(*folds[name], d,
                                      torch.where(i >= 0, i + s, -1), K)
        mirror[s:s + chunk] = (x @ proj).to(mirror_dtype)
        xsq_eff[s:s + chunk] = torch.where(row_ok, x_sq, PAD_ROW)
        scale = x.abs().amax(dim=1).clamp_min(1e-9) / 127.0
        xi8[s:s + chunk] = torch.round(x / scale[:, None]).to(torch.int8)
        scales[s:s + chunk] = scale
        del x
    return Tables(mirror, xsq_eff, xi8, scales, folds["all"],
                  folds["filtered"], rerank_dtype)


def filtered_norms(t: Tables) -> torch.Tensor:
    """``xsq_eff`` with every row but ids % FILTER_EVERY == 0 at PAD_ROW:
    the filter, for both stages."""
    gid = torch.arange(t.xsq_eff.shape[0], device=t.xsq_eff.device)
    return torch.where(gid % FILTER_EVERY == 0, t.xsq_eff, PAD_ROW)


def select_blocks(t: Tables, qm: torch.Tensor, blocks_k: int,
                  xsq_eff: torch.Tensor) -> torch.Tensor:
    """Stage 1: int64 [b, blocks_k], the blocks of the smallest minima."""
    mins = block_min_scan(qm, t.mirror, xsq_eff)
    return torch.topk(mins, blocks_k, dim=1, largest=False).indices


def rerank(t: Tables, q: torch.Tensor, bidx: torch.Tensor,
           xsq_eff: torch.Tensor, rows: torch.Tensor, wide: torch.Tensor):
    """Stage 2 for one slice of queries: the top K of the chosen blocks'
    rows by their int8 distances; an id whose row is invalid or filtered
    out (a score >= BIG_THRESH) reads -1. ``rows`` (int8) and ``wide``
    (f32) hold the gathered and the widened rows; the slices of one search
    reuse them."""
    qn, c = bidx.shape
    nb = t.xi8.shape[0] // BLOCK
    rows = torch.index_select(t.xi8.view(nb, BLOCK * DIM), 0,
                              bidx.reshape(-1), out=rows[:qn * c])
    wide = wide[:qn].copy_(rows.view(qn, c * BLOCK, DIM))
    qr = q.to(t.rerank_dtype).float()
    dots = torch.bmm(wide, qr[:, :, None])[:, :, 0]
    sc = t.scales.view(nb, BLOCK)[bidx].view(qn, -1)
    xq = xsq_eff.view(nb, BLOCK)[bidx].view(qn, -1)
    d = xq - 2.0 * sc * dots + (q * q).sum(dim=1, keepdim=True)
    top_d, pos = torch.topk(d, K, dim=1, largest=False)
    ids = (bidx[:, :, None] * BLOCK
           + torch.arange(BLOCK, device=bidx.device)).view(qn, -1)
    ids = torch.gather(ids, 1, pos).int()
    return top_d, torch.where(top_d < BIG_THRESH, ids, -1)


def rerank_all(t: Tables, q: torch.Tensor, bidx: torch.Tensor,
               xsq_eff: torch.Tensor):
    """Stage 2 for every query, QS at a time."""
    qn, c = min(QS, q.shape[0]), bidx.shape[1]
    rows = torch.empty((qn * c, BLOCK * DIM), dtype=torch.int8,
                       device=q.device)
    wide = torch.empty((qn, c * BLOCK, DIM), device=q.device)
    parts = [rerank(t, q[s:s + QS], bidx[s:s + QS], xsq_eff, rows, wide)
             for s in range(0, q.shape[0], QS)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def search(t: Tables, q: torch.Tensor, qm: torch.Tensor, blocks_k: int,
           xsq_eff: torch.Tensor | None = None):
    """The two-stage search of queries ``q`` (f32 [b, DIM]) with their
    projections ``qm``: (f32 [b, K], int32 [b, K]). ``xsq_eff`` in place of
    the tables' norms applies a filter."""
    xsq_eff = t.xsq_eff if xsq_eff is None else xsq_eff
    return rerank_all(t, q, select_blocks(t, qm, blocks_k, xsq_eff),
                      xsq_eff)


def recall_vs(ids: np.ndarray, oracle: np.ndarray) -> float:
    return float(np.mean([
        len(set(ids[i].tolist()) & set(oracle[i].tolist())) / K
        for i in range(len(oracle))]))


def _host(t: torch.Tensor) -> np.ndarray:
    """A device-to-host copy: the sync that ends every timed call."""
    return t.cpu().numpy()


def perturbed(q: torch.Tensor, proj: torch.Tensor, r: int):
    """The r-th timed batch: q * (1 + (r + 1) 1e-6) and its projection."""
    qv = q * (1.0 + (r + 1) * 1e-6)
    return qv, qv @ proj


def timed(call, q: torch.Tensor, proj: torch.Tensor, reps: int):
    """``call(q, q @ proj) -> (d, ids)`` once, untimed (the warm-up, whose
    answer is returned and measured), then (wall s, device ms) of ``reps``
    calls on perturbed batches made before the window, each call ending in
    a D2H copy of its ids; the device time from CUDA events around the
    call (None on the CPU, where nothing is measured)."""
    first = call(q, q @ proj)
    batches = [perturbed(q, proj, r) for r in range(reps)]
    out = []
    for qv, qmv in batches:
        cuda = qv.is_cuda
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        _, ids = call(qv, qmv)
        if cuda:
            end.record()
        _host(ids)
        wall = time.perf_counter() - t0
        out.append((wall, start.elapsed_time(end) if cuda else None))
    return first, out


def timed_pipelined(call, q: torch.Tensor, proj: torch.Tensor, reps: int,
                    depth: int) -> float:
    """Median wall seconds of ``call`` over ``depth`` perturbed batches
    (made before the window) dispatched back to back on the current stream,
    with one sync after the last; ``reps`` windows."""
    walls = []
    for r in range(reps):
        batches = [perturbed(q, proj, r * depth + i) for i in range(depth)]
        t0 = time.perf_counter()
        outs = [call(qv, qmv) for qv, qmv in batches]
        _host(outs[-1][1])
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def medians(reps: list):
    """(median wall s, median device ms or None) of ``timed``'s reps."""
    dev = [d for _, d in reps if d is not None]
    return (statistics.median(w for w, _ in reps),
            statistics.median(dev) if dev else None)


def stage_ms(t: Tables, q: torch.Tensor, qm: torch.Tensor, blocks_k: int):
    """Median device ms of stage 1 (block minima and the block choice) and
    stage 2 (gather, widening, products, top-k) over REPS calls, from CUDA
    events; (None, None) on the CPU."""
    if not q.is_cuda:
        return None, None
    times = []
    for _ in range(REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        bidx = select_blocks(t, qm, blocks_k, t.xsq_eff)
        ev[1].record()
        rerank_all(t, q, bidx, t.xsq_eff)
        ev[2].record()
        ev[2].synchronize()
        times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    return (statistics.median(a for a, _ in times),
            statistics.median(b for _, b in times))


def measure(t: Tables, queries: torch.Tensor, proj: torch.Tensor,
            results: dict, save) -> None:
    """The ladder, the routed point, sustained throughput, the filtered
    search and small-batch latency into ``results``; ``save()`` after
    each."""
    b = queries.shape[0]
    qm = queries @ proj
    gt = _host(t.truth[1])
    gt_f = _host(t.truth_filtered[1])

    op = {}
    for c in BLOCKS_K:
        (_, ids), reps = timed(lambda qv, qmv: search(t, qv, qmv, c),
                               queries, proj, REPS)
        rec = recall_vs(_host(ids), gt)
        wall, dev_ms = medians(reps)
        op[c] = {"blocks_k": c, "recall": rec, "qps": b / wall,
                 "device_ms": dev_ms}
        log(f"blocks_k={c}: recall@{K}={rec:.4f} qps={b / wall:.0f} "
            f"device {dev_ms} ms")
        results["ops"].append(op[c])
        save()

    # calibrate on the first half of the queries (the smallest blocks_k
    # reaching TARGET), report on the held-out half
    cal = b // 2
    routed = next((c for c in BLOCKS_K if recall_vs(
        _host(search(t, queries[:cal], qm[:cal], c)[1]), gt[:cal])
        >= TARGET), BLOCKS_K[-1])
    _, ids = search(t, queries[cal:], qm[cal:], routed)
    s1, s2 = stage_ms(t, queries, qm, routed)
    results["routed"] = {
        "target": TARGET, "blocks_k": routed,
        "holdout_recall": recall_vs(_host(ids), gt[cal:]),
        "qps": op[routed]["qps"], "stage1_device_ms": s1,
        "stage2_device_ms": s2}
    log(f"routed: {results['routed']}")
    save()

    wall = timed_pipelined(lambda qv, qmv: search(t, qv, qmv, routed),
                           queries, proj, REPS, QUEUE_DEPTH)
    results["sustained_d8"] = {
        "blocks_k": routed, "queue_depth": QUEUE_DEPTH,
        "qps": QUEUE_DEPTH * b / wall, "recall": op[routed]["recall"]}
    log(f"sustained d8: {results['sustained_d8']['qps']:.0f} qps")
    save()

    xsq_f = filtered_norms(t)
    (_, fids), reps = timed(lambda qv, qmv: search(t, qv, qmv, routed, xsq_f),
                            queries, proj, REPS)
    del xsq_f
    fids = _host(fids)
    leaked = int((fids[fids >= 0] % FILTER_EVERY != 0).sum())
    if leaked:
        raise AssertionError(f"filter leaked: {leaked} filtered-out ids")
    wall, dev_ms = medians(reps)
    results["filtered_10pct"] = {
        "blocks_k": routed, "recall": recall_vs(fids, gt_f),
        "qps": b / wall, "device_ms": dev_ms, "pads": int((fids < 0).sum())}
    log(f"filtered (10 %): {results['filtered_10pct']}")
    save()

    results["latency"] = {"rows": []}
    for nb in LATENCY_B:
        (_, lid), reps = timed(lambda qv, qmv: search(t, qv, qmv, routed),
                               queries[:nb], proj, LATENCY_REPS)
        wall, dev_ms = medians(reps)
        row = {"B": nb, "blocks_k": routed,
               "recall_sample": recall_vs(_host(lid), gt[:nb]),
               "wall_ms": wall * 1e3, "device_ms": dev_ms}
        results["latency"]["rows"].append(row)
        log(f"latency: {row}")
    save()


def run(n: int, device, out_path, source: dict | None = None) -> dict:
    """The whole benchmark over ``n`` rows on ``device``; ``source`` (numpy
    ``mix``, ``extra``, ``queries``, ``chunks``) in place of the script's
    own generator. Writes ``out_path``, prints the one result line and
    returns the results."""
    dev = torch.device(device)
    gpu = card()
    mix, extra, queries, rows_of = (
        own_source(dev, SEED, DP, B, CHUNK) if source is None
        else given_source(source, dev))
    proj = projection(mix, extra)
    n_chunks = -(-n // CHUNK)
    log(f"bench_10m_torch on {dev} ({gpu}): N={n} in {n_chunks} chunks of "
        f"{CHUNK}, B={queries.shape[0]}, DP={DP}")
    t0 = time.perf_counter()
    t = build_tables(queries, proj, rows_of, n, CHUNK, torch.bfloat16)
    _host(t.truth[1])
    build_s = time.perf_counter() - t0
    log(f"gen + truth + mirrors: {build_s:.1f} s")
    results = {"N": n, "dim": DIM, "dp": DP, "build_s": build_s,
               "memory_gb": t.nbytes(), "ops": [], "card": gpu,
               "device": str(dev), "torch": torch.__version__,
               "cuda": torch.version.cuda}

    def save():
        Path(out_path).write_text(json.dumps(results, indent=2))

    save()
    measure(t, queries, proj, results, save)
    print(json.dumps(results), flush=True)
    return results


def main() -> int:
    # the truth's f32 products stay f32 (l2_topk's plain paths and the
    # projection refuse or lose precision under TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        device = resolve_device("cuda")
    except RuntimeError as e:
        log(f"bench_10m_torch: {e}")
        return 1
    run(int(os.environ.get("BENCH10M_N", 10_000_000)), device,
        ROOT / "BENCH_10M_TORCH.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
