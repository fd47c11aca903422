#!/usr/bin/env python
"""SIFT1M-shaped IVF benchmark (BASELINE.md config 3 on realistic data) on
the PyTorch + CUDA port: scripts/bench_sift.py's rows, sizes, seeds and
sweep points, at 1M x 128.

    python3 scripts/bench_sift_torch.py   # BENCH_N rows, default 1,000,000

The corpus is ``datasets.sift_like(N, 128, seed=0, queries=1000)`` (the real
TEXMEX files instead when SIFT1M_DIR points at them). Rows, against the
exact f32 truth on ``l2_topk``:

- ``exact_f32`` (``l2_topk``, f32 table), ``bf16_scan`` (``l2_topk``, bf16
  table) and ``blocksel_3p`` (``block_min`` over the bf16 table itself, then
  the mirror and exact rescores);
- ``probe_ceiling`` at n_probe 8 / 16 / 32 / 64 over IvfIndex(4096),
  spill 2;
- ``ivf_rp`` at (n_probe, fetch) (8, 128), (32, 128), (4096, 256), RP at
  the full 128 dims;
- ``ivf_pq_residual``: a spill-1 rebuild with residual PQ m = 16, OPQ 4;
  11 rows of (n_probe, fetch, k, adc). ``adc`` "onehot8" and "pallas" both
  run the ``adc_probe`` kernel on the card (the TPU's one-hot MXU encoding
  and its Pallas kernel compute the same LUT sum); "gather" runs its plain
  formulation, as JAX's "gather" is XLA outside any Pallas kernel; at
  n_probe = 4096 the full scan runs ``adc_topk``. Each row says so under
  ``port_adc``. The k = 100 rows hold recall@100 against the exact top 100;
- ``pq_adc_scan``: a plain PQCodec (m 16, nbits 8, trained on the first
  131,072 rows) over every row, ADC on ``adc_topk`` at k = 100, set recall
  @100 and R@1 / 10 / 100.

Each row is timed as scripts/bench_sift.py's ``timed`` times it: 3 warm-up
calls on perturbed queries, then 3 reps, each ending in a sync or a copy to
the host; QPS from the host clock, ``device_ms`` the median rep from CUDA
events. Not carried over (relay and TPU-only workarounds): the compile
cache; ``jax.default_backend()`` choosing the Pallas phase 1 (the port's
``block_select_search_3p`` always runs ``block_min``). The spill-2 index is
freed before the spill-1 rebuild unless the caller keeps it (``keep``), as
the latency benchmark does.

Writes BENCH_SIFT_TORCH.json (BENCH_OUT) with the card's name and power
limit, and prints it as one JSON line. Runs on the card only: without one
it prints no result and exits 1. Progress goes to stderr.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import (  # noqa: E402
    ROOT, card, cli, env_int, finish, header, host, launch_counts,
    launches_since, log, probe_ceiling, recall_of, saver, sift_corpus, sync,
    timed)
from vector_db_tpu_torch.index.ivf import IvfIndex  # noqa: E402
from vector_db_tpu_torch.index.pq import PQCodec, _encode_scan  # noqa: E402
from vector_db_tpu_torch.ops.distance import squared_norms  # noqa: E402
from vector_db_tpu_torch.ops.exact import (  # noqa: E402
    approx_search_tiled,
    block_select_search_3p,
    exact_search_tiled,
)

B, K, K100 = 1000, 10, 100
PROBES = (8, 16, 32, 64)


def pq_rows(k_cells: int):
    """(n_probe, fetch, k, adc) of scripts/bench_sift.py:208-229."""
    return [(16, 128, 10, "onehot8"), (16, 128, 10, "pallas"),
            (16, 128, 10, "gather"), (16, 512, 10, "gather"),
            (16, 512, 10, "onehot8"), (16, 512, 10, "pallas"),
            (16, 1024, 10, "pallas"), (k_cells, 128, 10, "onehot8"),
            (16, 256, 100, "onehot8"), (16, 256, 100, "pallas"),
            (16, 256, 100, "gather")]


def port_adc(n_probe: int, k_cells: int, adc: str) -> str:
    """What an ivf_pq_residual row runs on the port."""
    if n_probe >= k_cells:
        return "adc_topk kernel (full scan over every cell)"
    if adc == "gather":
        return ("plain formulation (adc_probe_plain; JAX's gather is XLA "
                "outside any Pallas kernel)")
    return "adc_probe kernel"


def run(n: int, device, out_path, source: dict | None = None,
        k_cells: int = 4096, spill: int = 2, rp_dims: int | None = None,
        keep: dict | None = None) -> dict:
    """The benchmark over ``n`` rows on ``device``; ``source`` (numpy
    ``x``, ``q``, optional ``data`` label) in place of the corpus. ``keep``
    (a dict) receives the spill-``spill`` IVF index with RP enabled as
    ``ivf`` (and ``x``, ``q``), which is then not freed. Writes
    ``out_path``, prints the one result line and returns the results."""
    dev = torch.device(device)
    gpu = card()
    x, q, label = sift_corpus(n, B, source)
    n, dim = x.shape
    log(f"bench_sift_torch on {dev} ({gpu}): data {label} ({n}x{dim})")
    results = {"N": n, "dim": dim, "data": label, **header(dev, gpu)}
    save = saver(results, out_path)

    t0 = time.perf_counter()
    ivf = IvfIndex(k=k_cells, device=dev)
    ivf.build_arrays(range(n), x, seed=0, iters=20, spill=spill,
                     list_cap_alpha=2.0)
    sync(ivf._emb)
    build_s = time.perf_counter() - t0
    log(f"ivf build (k={k_cells}, spill={spill}): {build_s:.1f}s")
    results.update(build_s=build_s, k_cells=k_cells, spill=spill)

    qd = torch.from_numpy(q).to(dev)
    tile = 31250 if n % 31250 == 0 else 25000
    gt = host(exact_search_tiled(qd, ivf._emb, ivf._has_emb, K,
                                 tile=tile)[1])
    gt_ids = ivf._store.ids_of(gt)

    before = launch_counts()
    qps, dms = timed(lambda v: exact_search_tiled(
        v, ivf._emb, ivf._has_emb, K, tile=tile)[0], qd, B)
    log(f"exact f32: {qps:.0f} qps (recall 1.0)")
    results["exact_f32"] = {"qps": qps, "recall": 1.0, "device_ms": dms,
                            "launches": launches_since(before)}

    emb16 = ivf._emb.to(torch.bfloat16)
    x_sq = squared_norms(ivf._emb)
    tile16 = 125000 if n % 125000 == 0 else tile
    before = launch_counts()
    _, slots = approx_search_tiled(qd, emb16, ivf._has_emb, K, tile=tile16,
                                   x_sq=x_sq)
    rec = recall_of(ivf._store.ids_of(host(slots)), gt_ids, K)
    qps, dms = timed(lambda v: approx_search_tiled(
        v, emb16, ivf._has_emb, K, tile=tile16, x_sq=x_sq)[0], qd, B)
    log(f"bf16 scan: {qps:.0f} qps recall={rec:.4f}")
    results["bf16_scan"] = {"qps": qps, "recall": rec, "device_ms": dms,
                            "launches": launches_since(before)}

    # at 128-d the bf16 table itself is the phase-1/2 mirror
    def run_3p(v):
        return block_select_search_3p(v, emb16, v, x_sq, ivf._emb,
                                      ivf._has_emb, K, blocks_k=2 * K,
                                      rows_k=8 * K)[0]

    before = launch_counts()
    _, slots = block_select_search_3p(qd, emb16, qd, x_sq, ivf._emb,
                                      ivf._has_emb, K, blocks_k=2 * K,
                                      rows_k=8 * K)
    rec = recall_of(ivf._store.ids_of(host(slots)), gt_ids, K)
    qps, dms = timed(run_3p, qd, B)
    log(f"blocksel_3p: {qps:.0f} qps recall={rec:.4f}")
    results["blocksel_3p"] = {"qps": qps, "recall": rec, "device_ms": dms,
                              "launches": launches_since(before)}
    del emb16, x_sq

    ceil = probe_ceiling(ivf.inverted_lists, n, ivf.centroids, q, gt_ids,
                         PROBES)
    results["probe_ceiling"] = {str(p): c for p, c in ceil.items()}
    log(f"probe ceilings: {ceil}")

    t0 = time.perf_counter()
    ivf.enable_rp(dims=rp_dims or dim)
    ivf.search_batch(q[:8], n_probe=8, top_k=K, rp=True)
    log(f"enable_rp: {time.perf_counter() - t0:.1f}s")
    results["ivf_rp"] = []
    for n_probe, fetch in [(8, 128), (32, 128), (k_cells, 256)]:
        def run_rp(v, n_probe=n_probe, fetch=fetch):
            return ivf.search_batch(host(v), n_probe=n_probe, top_k=K,
                                    rp=True, fetch=fetch)[0]

        before = launch_counts()
        _, ids = ivf.search_batch(q, n_probe=n_probe, top_k=K, rp=True,
                                  fetch=fetch)
        qps, dms = timed(run_rp, qd, B)
        rec = recall_of(ids, gt_ids, K)
        log(f"ivf-rp n_probe={n_probe} fetch={fetch}: recall={rec:.4f} "
            f"qps={qps:.0f}")
        results["ivf_rp"].append({"n_probe": n_probe, "fetch": fetch,
                                  "recall": rec, "qps": qps,
                                  "device_ms": dms,
                                  "launches": launches_since(before)})
    save()

    # residual IVF-PQ needs one code per slot: a single-assignment index
    if spill > 1:
        log("rebuilding single-assignment index for residual PQ...")
        if keep is not None:
            keep.update(ivf=ivf, x=x, q=q)
        del ivf
        gc.collect()
        ivf2 = IvfIndex(k=k_cells, device=dev)
        ivf2.build_arrays(range(n), x, seed=0, iters=20, spill=1,
                          list_cap_alpha=2.0)
    else:
        ivf2 = ivf
        if keep is not None:
            keep.update(ivf=ivf, x=x, q=q)
    t0 = time.perf_counter()
    ivf2.enable_pq(chunks=16, ksub=256, opq_iters=4, residual=True)
    ivf2.search_batch(q[:8], n_probe=8, top_k=K, pq=True)
    log(f"enable_pq(residual m=16): {time.perf_counter() - t0:.1f}s")
    gt100 = host(exact_search_tiled(qd, ivf2._emb, ivf2._has_emb, K100,
                                    tile=tile)[1])
    gt100_ids = ivf2._store.ids_of(gt100)
    results["ivf_pq_residual"] = []
    for n_probe, fetch, kk, adc in pq_rows(k_cells):
        def run_pq(v, n_probe=n_probe, fetch=fetch, kk=kk, adc=adc):
            return ivf2.search_batch(host(v), n_probe=n_probe, top_k=kk,
                                     pq=True, fetch=fetch, adc=adc)[0]

        before = launch_counts()
        _, ids = ivf2.search_batch(q, n_probe=n_probe, top_k=kk, pq=True,
                                   fetch=fetch, adc=adc)
        rec = recall_of(ids, gt_ids if kk == K else gt100_ids, kk)
        qps, dms = timed(run_pq, qd, B)
        log(f"ivf-pq(res) n_probe={n_probe} fetch={fetch} k={kk} "
            f"adc={adc}: recall={rec:.4f} qps={qps:.0f}")
        results["ivf_pq_residual"].append(
            {"n_probe": n_probe, "fetch": fetch, "k": kk, "adc": adc,
             "recall": rec, "qps": qps, "device_ms": dms,
             "launches": launches_since(before),
             "port_adc": port_adc(n_probe, k_cells, adc)})
        save()

    # BASELINE config 3's literal row: plain PQ m=16 nbits=8 over ALL codes
    codec = PQCodec(k=256, chunks=16, dim=dim, device=dev)
    t0 = time.perf_counter()
    codec.train(np.asarray(x[:131072], np.float32), seed=0, restarts=2)
    codes = _encode_scan(ivf2._emb, codec.codebooks, chunk=8192)[:n]
    sync(codes)
    log(f"plain pq train+encode: {time.perf_counter() - t0:.1f}s")
    live = ivf2._has_emb[:n]

    def run_adc(v):
        return codec.adc_search(host(v), codes, live, top_k=K100)[0]

    before = launch_counts()
    _, rows = codec.adc_search(q, codes, live, top_k=K100)
    adc_ids = ivf2._store.ids_of(rows)
    rec100 = recall_of(adc_ids, gt100_ids, K100)
    r_at = {R: float(np.mean([gt100_ids[i][0] in set(adc_ids[i][:R].tolist())
                              for i in range(len(gt100_ids))]))
            for R in (1, 10, 100)}
    qps, dms = timed(run_adc, qd, B)
    log(f"pq-adc full scan m=16: set-recall@100={rec100:.4f} "
        f"R@1/10/100={r_at[1]:.3f}/{r_at[10]:.3f}/{r_at[100]:.3f} "
        f"qps={qps:.0f}")
    results["pq_adc_scan"] = {
        "chunks": 16, "ksub": 256, "bytes_per_vec": 16, "k": K100,
        "set_recall_at_100": rec100,
        "recall_at_R": {str(R): r_at[R] for R in r_at}, "qps": qps,
        "device_ms": dms, "launches": launches_since(before)}
    return finish(results, out_path)


def main() -> int:
    return cli("bench_sift_torch", lambda dev: run(
        env_int("BENCH_N", 1_000_000), dev,
        os.environ.get("BENCH_OUT", str(ROOT / "BENCH_SIFT_TORCH.json")),
        k_cells=env_int("BENCH_IVF_K", 4096),
        spill=env_int("BENCH_IVF_SPILL", 2),
        rp_dims=(env_int("BENCH_RP_DIMS", 0) or None)))


if __name__ == "__main__":
    sys.exit(main())
