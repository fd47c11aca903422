#!/usr/bin/env python
"""1M x 768-d flagship benchmark (BASELINE.md config 4) on the PyTorch +
CUDA port: scripts/bench_1m.py's rows, sizes, seeds and sweep points, every
index mode on one card against the same exact f32 truth.

    python3 scripts/bench_1m_torch.py     # BENCH_N rows, default 1,000,000

The corpus is ``datasets.embedding_like(N + 1000, 768, seed=0)`` (clustered,
rank 64): the first N rows, then 1000 queries. The HNSW (M 16,
ef_construction 200, ``random.Random(42)``, l_max 5) is bulk-built fresh
every run, so ``build_s`` is always a fresh build. Sections (BENCH_SECTIONS,
comma-separated, default ``all``), each run as scripts/bench_1m.py runs it:

- ``scan``: exact f32 and bf16 on ``l2_topk``; blocksel_exact / bf16 /
  bf16_k (``block_select_search``, plain torch as in JAX) and, over a PCA-128
  bf16 mirror, blocksel_proj_k / proj / proj_4k;
- ``scan3p``: ``block_select_search_3p`` over the mirror (``block_min``);
- ``scan2p``: ``block_select_search_2p`` (``block_topm``, m 2);
- ``wide`` (5 rows) and ``beam`` (3 rows) over ``enable_wide(120, 16384,
  inline)``; ``hnsw``: the classic beam at ef 200 / 400;
- ``filter``: 10 % and 2 % random filters (``default_rng(11)``): the masked
  scans, the wide beam at two depths and (10 % only) the classic beam,
  against the filtered exact truth;
- ``rp``: projected traversal at ef 200 / 400 / 600; ``opq``: PQ traversal
  after ``enable_pq(16, 256, opq_iters=8)`` at ef 400; ``widepq``: the
  PQ-scored wide beam at ef 1536 and 2048;
- ``ivf``: IvfIndex(4096) spill 2 at 768-d, probe ceilings at 64 / 128 /
  256 and RP (128 dims) at (64, 128), (256, 256), (4096, 64).

The wide rows run with ``merge_kernel=False``, the default in both
packages, so they launch no ``sorted_topk``. Each row is timed as the JAX
script's ``timed`` times it: 3 warm-up calls on perturbed queries, then 3
reps, each ending in a sync or a copy to the host; QPS from the host clock,
``device_ms`` the median rep from CUDA events.

Not carried over (relay and TPU-only workarounds): the compile cache;
the /tmp/wide1m_cache corpus and graph cache (BENCH_1M_CACHE); the resume
into an existing JSON file (BENCH_SECTIONS only selects sections). The
HNSW is freed before the IVF build unless the caller keeps it (``keep``),
as the latency benchmark does.

Writes BENCH_1M_TORCH.json with the card's name and power limit, and
prints it as one JSON line. Runs on the card only: without one it prints no
result and exits 1. Progress goes to stderr.
"""

from __future__ import annotations

import gc
import os
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import (  # noqa: E402
    ROOT, card, cli, env_int, finish, header, host, launch_counts,
    launches_since, log, probe_ceiling, recall_of, saver, sync, timed)
from vector_db_tpu_torch.datasets import embedding_like  # noqa: E402
from vector_db_tpu_torch.index.hnsw import HNSW  # noqa: E402
from vector_db_tpu_torch.index.ivf import IvfIndex  # noqa: E402
from vector_db_tpu_torch.ops.distance import squared_norms  # noqa: E402
from vector_db_tpu_torch.ops.exact import (  # noqa: E402
    approx_search_tiled,
    block_select_search,
    block_select_search_2p,
    block_select_search_3p,
    exact_search_tiled,
)

DIM, B, K = 768, 1000, 10
SECTIONS = ("scan", "scan3p", "scan2p", "wide", "widepq", "beam", "hnsw",
            "filter", "rp", "opq", "ivf")
WIDE = [(1024, 160, 10, False), (1280, 256, 8, False),
        (1280, 224, 9, False), (1280, 224, 10, False),
        (1280, 224, 10, True)]
BEAM = [(224, 12, 2), (256, 14, 2), (320, 12, 2)]
CLASSIC_EFS = (200, 400)
RP_EFS = (200, 400, 600)
WIDE_PQ = [(1536, 256, 10), (2048, 320, 10)]
SELECTIVITY = (0.1, 0.02)
IVF_PROBES = (64, 128, 256)


def rows_of(name: str, index, filt):
    """The filtered section's rows (scripts/bench_1m.py:361-379)."""
    calls = {
        "scan": lambda v: index.search_batch_scan(host(v), k=K,
                                                  filter_ids=filt),
        "scan_exact": lambda v: index.search_batch_scan(
            host(v), k=K, mode="exact", filter_ids=filt),
        "wide": lambda v: index.search_batch_wide(
            host(v), k=K, ef=1280, frontier=224, steps=10, rerank_k=256,
            seen_mask=False, filter_ids=filt),
        "wide_deep": lambda v: index.search_batch_wide(
            host(v), k=K, ef=1536, frontier=224, steps=12, rerank_k=512,
            seen_mask=False, filter_ids=filt),
        "classic": lambda v: index.search_batch(
            host(v), k=K, ef=400, expand=4, filter_ids=filt),
    }
    return calls[name]


def run(n: int, device, out_path, source: dict | None = None,
        b: int = B, k_cells: int = 4096, spill: int = 2, rp_dims: int = 128,
        sections: str = "all", keep: dict | None = None) -> dict:
    """The benchmark over ``n`` rows and ``b`` queries on ``device``;
    ``source`` (numpy ``x``, ``q``) in place of the corpus; ``sections`` as
    BENCH_SECTIONS. ``keep`` (a dict) receives the HNSW as ``hnsw`` with
    ``q`` and the truth's ids ``gt``, which is then not freed. Writes
    ``out_path``, prints the one result line and returns the results."""
    dev = torch.device(device)
    gpu = card()
    sec = set(sections.split(","))

    def want(s):
        return "all" in sec or s in sec

    if source is None:
        log(f"generating {n}x{DIM} (clustered embedding-like)...")
        t0 = time.perf_counter()
        data = embedding_like(n + b, DIM, 0)
        x, q = data[:n], data[n:]
        log(f"data {time.perf_counter() - t0:.1f}s")
    else:
        x = np.asarray(source["x"], np.float32)[:n]
        q = np.ascontiguousarray(np.asarray(source["q"], np.float32)[:b])
    n, b = x.shape[0], q.shape[0]

    before = launch_counts()
    t0 = time.perf_counter()
    index = HNSW(M=16, ef_construction=200, rng=random.Random(42),
                 capacity=n, l_max=5, device=dev)
    index.bulk_build(list(range(n)), x)
    sync(index.graph.neighbors)
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f}s = {n / build_s:.0f} vec/s")
    build_launches = launches_since(before)

    qd = torch.from_numpy(q).to(dev)
    tile = 31250 if n % 31250 == 0 else 25000
    t0 = time.perf_counter()
    gt = index._store.ids_of(host(exact_search_tiled(
        qd, index._emb, index._has_emb, K, tile=tile)[1]))
    log(f"exact gt: {time.perf_counter() - t0:.1f}s")

    results = {"N": n, "dim": DIM, "B": b,
               "data": "clustered rank-64 embedding-like", "hnsw": [],
               "hnsw_opq": [], "build_s": build_s, "build_vps": n / build_s,
               "build_launches": build_launches,
               "sections": sorted(sec), **header(dev, gpu)}
    save = saver(results, out_path)

    def row(name, run_fn, ids, before):
        """A row's timing, its recall and the kernels it launched since
        ``before`` (its answer's call included)."""
        qps, dms = timed(run_fn, qd, b)
        rec = recall_of(ids, gt, K)
        log(f"{name}: recall={rec:.4f} qps={qps:.0f}")
        return {"qps": qps, "recall": rec, "device_ms": dms,
                "launches": launches_since(before)}

    def slots_ids(slots):
        return index._store.ids_of(host(slots))

    emb, has = index._emb, index._has_emb
    if want("scan"):
        results["exact_f32"] = row(
            "exact f32", lambda v: exact_search_tiled(v, emb, has, K,
                                                      tile=tile)[0],
            gt, launch_counts())
        emb16 = emb.to(torch.bfloat16)
        x_sq = squared_norms(emb)
        tile16 = 125000 if n % 125000 == 0 else tile
        before = launch_counts()
        _, ids = approx_search_tiled(qd, emb16, has, K, tile=tile16,
                                     x_sq=x_sq)
        results["bf16_scan"] = row(
            "bf16 scan", lambda v: approx_search_tiled(
                v, emb16, has, K, tile=tile16, x_sq=x_sq)[0],
            slots_ids(ids), before)
        for name, tab, extra in [
                ("blocksel_exact", emb, {"exact_phase1": True,
                                         "blocks_k": K}),
                ("blocksel_bf16", emb16, {"blocks_k": 2 * K}),
                ("blocksel_bf16_k", emb16, {"blocks_k": K})]:
            def run_bs(v, tab=tab, extra=extra):
                return block_select_search(v, tab, v, x_sq, emb, has, K,
                                           tile=131072, **extra)[0]

            before = launch_counts()
            _, ids = block_select_search(qd, tab, qd, x_sq, emb, has, K,
                                         tile=131072, **extra)
            results[name] = row(name, run_bs, slots_ids(ids), before)
        t0 = time.perf_counter()
        index.enable_rp(dims=rp_dims)
        rp_tab, rp_xsq = index._rp_tables()
        sync(rp_tab)
        log(f"enable_rp + mirror: {time.perf_counter() - t0:.1f}s")
        proj = index._rp_proj
        for name, bk in [("blocksel_proj_k", K), ("blocksel_proj", 2 * K),
                         ("blocksel_proj_4k", 4 * K)]:
            def run_proj(v, bk=bk):
                return block_select_search(v, rp_tab, v @ proj, rp_xsq, emb,
                                           has, K, tile=131072,
                                           blocks_k=bk)[0]

            before = launch_counts()
            _, ids = block_select_search(qd, rp_tab, qd @ proj, rp_xsq, emb,
                                         has, K, tile=131072, blocks_k=bk)
            results[name] = row(name, run_proj, slots_ids(ids), before)
        del emb16, x_sq, rp_tab, rp_xsq
        save()

    if want("scan3p") or want("scan2p"):
        x_sq = squared_norms(emb)
        index.enable_rp(dims=rp_dims)
        rp_tab, _ = index._rp_tables()
        proj = index._rp_proj
    if want("scan3p"):
        def run_3p(v):
            return block_select_search_3p(v, rp_tab, v @ proj, x_sq, emb,
                                          has, K, blocks_k=2 * K,
                                          rows_k=8 * K)[0]

        before = launch_counts()
        _, ids = block_select_search_3p(qd, rp_tab, qd @ proj, x_sq, emb,
                                        has, K, blocks_k=2 * K, rows_k=8 * K)
        results["blocksel_3p"] = row("blocksel_3p", run_3p, slots_ids(ids),
                                     before)
        save()
    if want("scan2p"):
        def run_2p(v):
            return block_select_search_2p(v, rp_tab, v @ proj, x_sq, emb,
                                          has, K, block=128, m=2,
                                          rows_k=8 * K)[0]

        before = launch_counts()
        _, ids = block_select_search_2p(qd, rp_tab, qd @ proj, x_sq, emb,
                                        has, K, block=128, m=2, rows_k=8 * K)
        results["blocksel_2p"] = row("blocksel_2p", run_2p, slots_ids(ids),
                                     before)
        save()
    if want("scan3p") or want("scan2p"):
        del x_sq, rp_tab

    if want("wide") or want("widepq"):
        t0 = time.perf_counter()
        index.enable_wide(dims=120, seeds=16384, inline=want("wide"))
        log(f"enable_wide: {time.perf_counter() - t0:.1f}s")
    if want("wide"):
        index.search_batch_wide(q[:8], k=K, ef=64, frontier=16, steps=4)
        results["hnsw_wide"] = []
        for ef, f, t, seen in WIDE:
            def run_w(v, ef=ef, f=f, t=t, seen=seen):
                return index.search_batch_wide(host(v), k=K, ef=ef,
                                               frontier=f, steps=t,
                                               seen_mask=seen)[0]

            before = launch_counts()
            _, ids = index.search_batch_wide(q, k=K, ef=ef, frontier=f,
                                             steps=t, seen_mask=seen)
            r = row(f"hnsw-wide ef={ef} F={f} T={t} seen={seen}", run_w,
                    ids, before)
            results["hnsw_wide"].append(
                {"ef": ef, "F": f, "T": t, "seen": seen, **r})
        save()

    if want("beam"):
        if not hasattr(index, "_wb_n_seeds"):
            index.enable_wide(dims=120, seeds=16384, inline=True)
        index.search_batch_beam(q[:8], k=K, frontier=16, steps=4)
        results["hnsw_beam"] = []
        for f, t, hist in BEAM:
            def run_b(v, f=f, t=t, hist=hist):
                return index.search_batch_beam(host(v), k=K, frontier=f,
                                               steps=t, hist=hist)[0]

            before = launch_counts()
            _, ids = index.search_batch_beam(q, k=K, frontier=f, steps=t,
                                             hist=hist)
            r = row(f"hnsw-beam F={f} T={t} hist={hist}", run_b, ids, before)
            results["hnsw_beam"].append({"F": f, "T": t, "hist": hist, **r})
        save()

    if want("hnsw"):
        results["hnsw"] = []
        for ef in CLASSIC_EFS:
            def run_c(v, ef=ef):
                return index.search_batch(host(v), k=K, ef=ef, expand=4)[0]

            before = launch_counts()
            _, ids = index.search_batch(q, k=K, ef=ef, expand=4)
            results["hnsw"].append({"ef": ef, **row(f"hnsw ef={ef}", run_c,
                                                    ids, before)})
        save()

    if want("filter"):
        if not hasattr(index, "_wb_n_seeds"):
            index.enable_wide(dims=120, seeds=16384, inline=True)
        results["hnsw_filtered"] = []
        for sel in SELECTIVITY:
            rngf = np.random.default_rng(11)
            fslots = rngf.choice(n, size=int(n * sel), replace=False)
            filt = set(int(i) for i in fslots)      # slot == id here
            vmask = torch.from_numpy(index._store.filter_mask(filt)).to(
                dev) & has
            gt_f = slots_ids(exact_search_tiled(qd, emb, vmask, K,
                                                tile=31250)[1])
            names = ["scan", "scan_exact", "wide", "wide_deep", "classic"]
            if sel != 0.1:      # the JAX script skips the classic beam at 2 %
                names.remove("classic")
            for name in names:
                run_f = rows_of(name, index, filt)
                before = launch_counts()
                _, ids = run_f(q)
                qps, dms = timed(lambda v: run_f(v)[0], qd, b)
                rec = recall_of(ids, gt_f, K)
                log(f"hnsw-filtered sel={sel} {name}: recall={rec:.4f} "
                    f"qps={qps:.0f}")
                results["hnsw_filtered"].append(
                    {"engine": name, "selectivity": sel, "recall": rec,
                     "qps": qps, "device_ms": dms,
                     "launches": launches_since(before)})
                save()

    if want("rp"):
        t0 = time.perf_counter()
        index.enable_rp(dims=rp_dims)
        index.search_batch_rp(q[:8], k=K, ef=16)
        log(f"hnsw enable_rp: {time.perf_counter() - t0:.1f}s")
        results["hnsw_rp"] = []
        for ef in RP_EFS:
            def run_rp(v, ef=ef):
                return index.search_batch_rp(host(v), k=K, ef=ef,
                                             expand=4)[0]

            before = launch_counts()
            _, ids = index.search_batch_rp(q, k=K, ef=ef, expand=4)
            results["hnsw_rp"].append(
                {"ef": ef, **row(f"hnsw-rp ef={ef}", run_rp, ids, before)})
        save()

    if want("opq") or want("widepq"):
        t0 = time.perf_counter()
        index.enable_pq(chunks=16, ksub=256, opq_iters=8)
        log(f"enable_pq(opq): {time.perf_counter() - t0:.1f}s")
    if want("opq"):
        def run_pq(v):
            return index.search_batch_pq(host(v), k=K, ef=400, expand=4)[0]

        before = launch_counts()
        _, ids = index.search_batch_pq(q, k=K, ef=400, expand=4)
        results["hnsw_opq"].append({"ef": 400, **row("hnsw-opq ef=400",
                                                     run_pq, ids, before)})
    if want("widepq"):
        for ef, f, t in WIDE_PQ:
            def run_wpq(v, ef=ef, f=f, t=t):
                return index.search_batch_wide(host(v), k=K, ef=ef,
                                               frontier=f, steps=t,
                                               score="pq", rerank_k=ef)[0]

            before = launch_counts()
            _, ids = index.search_batch_wide(q, k=K, ef=ef, frontier=f,
                                             steps=t, score="pq",
                                             rerank_k=ef)
            results["hnsw_opq"].append(
                {"ef": ef, "F": f, "T": t, "mode": "wide",
                 **row(f"hnsw-opq-wide ef={ef}", run_wpq, ids, before)})
    save()

    if not want("ivf"):
        if keep is not None:
            keep.update(hnsw=index, q=q, gt=gt)
        return finish(results, out_path)

    # the IVF index owns its own table: the HNSW's goes first unless kept
    if keep is not None:
        keep.update(hnsw=index, q=q, gt=gt)
    del index, emb, has
    gc.collect()
    t0 = time.perf_counter()
    ivf = IvfIndex(k=k_cells, device=dev)
    ivf.build_arrays(range(n), x, seed=0, iters=20, spill=spill,
                     list_cap_alpha=2.0)
    sync(ivf._emb)
    ivf_build_s = time.perf_counter() - t0
    log(f"ivf build (k={k_cells}, spill={spill}): {ivf_build_s:.1f}s")
    ceil = probe_ceiling(ivf.inverted_lists, n, ivf.centroids, q, gt,
                         IVF_PROBES)
    log(f"probe ceilings: {ceil}")
    t0 = time.perf_counter()
    ivf.enable_rp(dims=rp_dims)
    ivf.search_batch(q[:8], n_probe=8, top_k=K, rp=True)
    log(f"ivf enable_rp: {time.perf_counter() - t0:.1f}s")
    results["ivf_rp"] = {"k_cells": k_cells, "spill": spill,
                         "build_s": ivf_build_s,
                         "probe_ceiling": {str(p): c
                                           for p, c in ceil.items()},
                         "ops": []}
    for n_probe, fetch in [(64, 128), (256, 256), (k_cells, 64)]:
        def run_ivf(v, n_probe=n_probe, fetch=fetch):
            return ivf.search_batch(host(v), n_probe=n_probe, top_k=K,
                                    rp=True, fetch=fetch)[0]

        before = launch_counts()
        _, ids = ivf.search_batch(q, n_probe=n_probe, top_k=K, rp=True,
                                  fetch=fetch)
        r = row(f"ivf-rp n_probe={n_probe} fetch={fetch}", run_ivf, ids,
                before)
        results["ivf_rp"]["ops"].append(
            {"n_probe": n_probe, "fetch": fetch, **r})
    del ivf
    return finish(results, out_path)


def main() -> int:
    return cli("bench_1m_torch", lambda dev: run(
        env_int("BENCH_N", 1_000_000), dev, ROOT / "BENCH_1M_TORCH.json",
        k_cells=env_int("BENCH_IVF_K", 4096),
        spill=env_int("BENCH_IVF_SPILL", 2),
        rp_dims=env_int("BENCH_RP_DIMS", 128),
        sections=os.environ.get("BENCH_SECTIONS", "all")))


if __name__ == "__main__":
    sys.exit(main())
