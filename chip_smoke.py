"""Drive the PyTorch + CUDA port (vector_db_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and the exit code is not 0:

1. device and build: the card's name and power limit, the TF32 flags (set
   off), and the nvcc build of the kernels from the checkout's sources;
2. each kernel against its plain PyTorch version on the card: edge shapes
   (ragged N, B = 1, B off the query tile, invalid rows, k above the valid
   rows, duplicate rows; for l2_topk every query group at d = 128 and 768,
   rows tied across tiles and CTAs, no valid row; for the block scans ds
   of 32, 100, 128, 200 and 300, m up to 128, B of 1, 70 and 1000, rows
   tied inside a block and across CTAs; for sorted_topk keys tied across
   the cut, one key, +-0.0, BIG sentinels at the cut, the widest row a CTA
   holds) and the main path's shapes, with both medians and torch.matmul
   of the same product (l2_topk in each dtype, the block scans in bf16);
3. the main path at real size: FlatIndex over a 1M x 768 embedding-like
   corpus in all four precisions (insert, delete, filter, search_batch at
   B = 1000, k = 10), checked against float64 ground truth and the port's
   own f32 scan, with QPS, peak memory and each kernel's launch count;
4. IVF-PQ at SIFT1M scale, the repo's IVF benchmark setting (IVFADC of
   Jegou et al., FAISS IVF4096,PQ16): IvfIndex over 1M x 128 sift_like rows,
   4096 cells, residual PQ m = 16 with OPQ, add, delete, filter, and
   search_batch at B = 1000 in the PQ-probe (n_probe = 16, fetch = 512)
   and flat modes against the port's exact scan; enable_rp(dims=128), RP
   at n_probe 8 and 32 (each held to its probe ceiling less 0.03) and over
   every cell (the flat mirror on l2_topk or the cell-block scan, as the
   residual ratio picks), and the residual-PQ full scan at n_probe 4096
   (adc_topk with its row and group terms, held against its plain version
   at the scan's own inputs, with its bound and lookup floor); then a
   PQCodec ADC scan of the corpus (adc_topk) against its gather mode, and a
   FlatIndex search at k = 300 (two passes of l2_topk) against float64;
5. HNSW at the repo's 1M benchmark setting (scripts/exp_wide_final.py:38-76,
   scripts/bench_1m.py:85-92), as a user runs it: bulk_build of the first
   983,616 of 1M x 768 embedding_like rows (M = 16, l_max = 5; level 0
   clustered, level 1 through knn_exact and l2_topk, higher levels in
   numpy), then the last 16,384 streamed in through insert_arrays in 16
   batches of 1024 (exact candidates on l2_topk, the grouped commit;
   inserts/s, peak memory, launches checked per batch, a profile of the
   insert), checks of the inserted rows (edges both ways, no self or
   duplicate edge, levels mirror, self top-1), 100 deletes,
   enable_wide(dims=128, seeds=16384), wide-beam search at ef = 1280,
   F = 224, T = 10 with and without the sorted_topk merge kernel, a
   filtered wide search at 10 % selectivity and the classic beam at
   ef = 400, all at B = 1000 against the port's exact scan; sorted_topk on
   the main path's own merge input; enable_rp(128) and projected
   traversal at ef 400 and 600, enable_pq(16, OPQ 8) and PQ traversal at
   ef 400, the PQ-scored wide beam (ef 1536, F 256, T 10, sorted_topk),
   enable_wide(dims=120, inline=True) and the pool-free beam at F 224 and
   320 (T 12, hist 2) and the inline wide beam at ef 1280; then
   save_index, and a reload into a new HNSW over MMapNodeStorage
   (bit-equal tables, the same ids, the PQ / RP state reloaded);
6. the port's services at the deployment of the repo's config.yaml
   (all-MiniLM-L6-v2 widths, d = 384, capacity 1,000,000, HNSW M = 16,
   ef_construction = 200, flush_threshold = 1000; the fake-384 embedder):
   ingest through StorageService + IndexingService (a bulk first load of
   949,980 documents, then 10 streamed batches of 5,000, each scheduling
   an async flush), a restart on the same files, 20 single inserts (each
   saving synchronously) and 100 deletes, the scan route (B = 1000), the
   wide route (B = 64), the filtered scan and 200 single queries, each
   equal to the direct index call and held against the port's exact
   scan; l2_topk, sorted_topk and adc_probe at the inputs the services'
   routes give them against their plain versions; a flat and an IVF-PQ
   service at 100,000 rows (the PQ probe and the full scan), an IVF
   service with index.rp, and HNSW services with index.rp, index.pq and
   index.wide.mode: beam; the HTTP app on 127.0.0.1; each line carries
   the card's name and power limit. The launch counts are the services'
   calls alone. The storage's text fields are SVC_FIELD_CHARS wide (the
   one cut; phase 11 runs the reference's widths);
7. at the same deployment: a. phase 6's HNSW service restarted with
   index.autotune, its decision tables and routed calls; b. the sharded
   indexes, 4 shards on the one card, beside the unsharded ones, and the
   sharded-hnsw service;
8. the port's headline benchmark, bench_torch.run, in this process: the
   HNSW detail at 100,000 and 10,000 x 384 rows and the scan modes at
   BENCH_HEADLINE_N x 768 (cut from 1M), per call and sustained at queue
   depth 8; its JSON line is logged, its rows held to phase 3's floors,
   and l2_topk (both tables), block_min and block_topm must launch.
9. the 10M x 768 configuration of scripts/bench_10m.py and its sharded
   form, scripts/dryrun_sharded_10m.py, by the port's
   scripts/bench_10m_torch.py and scripts/dryrun_sharded_10m_torch.py in
   this process at 10,000,000 rows (no cut): the corpus generated on the
   card chunk by chunk with its exact truth on l2_topk, the bf16 ds = 120
   mirror's stage 1 on block_min, the int8 rerank; the blocks_k ladder,
   the routed point, the filtered search, and the 8 shards' f32 mirrors
   and merge; each recall held to the JAX package's reading less 0.03,
   block_min (ds 120 bf16 and the shards' f32 table) and l2_topk held
   against their plain versions at the scripts' shapes and timed;
10. the benchmark scripts of BASELINE configs 3 and 4, scripts/bench_sift.py,
   bench_pq.py, bench_1m.py and bench_latency.py, by the port's
   scripts/bench_{sift,pq,1m,latency}_torch.py in this process at
   1,000,000 rows (no cut): SIFT-shaped 1M x 128 (phase 4's corpus) and
   1M x 768 (phase 5's corpus; a fresh HNSW build), the latency rows on the
   SIFT script's spill-2 index and the 1M script's HNSW. Each script's
   JSON line is logged; every row of the committed BENCH_SIFT.json,
   BENCH_PQ.json, BENCH_1M.json and BENCH_LATENCY.json must be in the
   port's, its recall at or above the JAX reading less 0.03 (1.0 for the
   lossless rows), and each row must launch its kernels; l2_topk at k 100
   over the SIFT table, block_min over its bf16 copy and adc_topk at k 100
   and 400 over the 1M x 16 codes are held against their plain versions
   and timed;
11. the last four JAX drivers, scripts/bench_insert.py, bench_tiered.py
   (BASELINE config 2), bench_sharded.py and bench_api.py, by the port's
   scripts/bench_{insert,tiered,sharded,api}_torch.py at the JAX scripts'
   sizes (no cut): streamed inserts into a 10,000-row HNSW in both commit
   modes (30,482 rows after); 100,000 x 384 through StorageService +
   IndexingService at the reference's field widths with a flush per batch,
   a restart on the same files and the ef sweep; 8 shards on the one card
   (a 4M x 64 flat index, a 262,144 x 64 HNSW streamed into, deleted from
   and searched under a 25 % filter); and the two HTTP services as
   separate processes over 100,000 documents. Each script's JSON line is
   logged; every key of the committed BENCH_INSERT.json,
   BENCH_TIERED.json, BENCH_SHARDED.json and BENCH_API.json must be in the
   port's, each recall at or above the JAX reading less 0.03 (the sharded
   flat index at 1.0), each row must launch its kernels (the API's read
   from its indexing process's /stats), and the scripts' facts hold (20
   flushes and the restart; the streamed rows in the graph and their own
   top-1; no deleted id back; filters; /health, /stats, both children
   ended); l2_topk at the insert scan (B 1024 and 4096, k 200), at one
   shard of the flat index and over tiered's bf16 mirror is held against
   its plain version and timed.

Phase 10's scripts time the classic RP / PQ and the beam rows at phase 5's
settings, so phase 5 times each of those once; the sharded HNSW of phase 7b
streams 2 of the service's 10 insert batches and bulk-builds the rest.
Phase 11's runs put the reference's storage widths through an ingest and a
restart, so phase 6 no longer times a full-width store.

Phases 3-6 also profile search modes (torch.profiler over 3 calls):
device busy time, idle share of the wall time, the largest device items.

Each kernel's record carries its time, its plain version's, a library
call's where one PyTorch call computes the same function, and its bound:
the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over the card's peak for their type
(H100 SXM: 67 TFLOP/s f32, 495 TFLOP/s TF32 and 989 TFLOP/s bf16 tensor
cores; l2_topk's f32 table runs as 3xTF32, three TF32 products).

The last line is {"ok": true, "device": {...}}; the line before it is the
kernels' JSON record, and the one before that the card's name and power
limit. Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np

N_MAIN = 1 << 20        # main-path kernel shapes
DIM = 768
DS = 128
B = 1000
K = 10
M_2P = 2                # FlatIndex's m for k <= 16
CORPUS = 1_000_000      # FlatIndex corpus rows (+ B query rows)
# kernel vs plain: a sum in another order errs relative to the size of its
# terms, so a distance's tolerance is ATOL + RTOL * (|value| + scale), with
# scale = ||q||^2 + max ||x||^2 for l2_topk (a near-zero distance is the
# difference of terms that large), the largest LUT sum plus the largest
# |corr| for adc_probe (the residual correction cancels ||q||^2 out of the
# LUT sum), max |xsq_eff live| + 2 ||q|| max ||x|| for the block scans (the
# bf16 table's products run on tensor cores, in another order than the
# plain product), and 0 for adc_topk
RTOL, ATOL = 1e-5, 1e-4
LIVE = 1e37             # below this a value belongs to a real row
# phase 4: the IVF-PQ benchmark setting (scripts/bench_sift.py:66, :195-201)
IVF_N = 1_000_000
IVF_DIM = 128
IVF_CELLS = 4096
PQ_M = 16
PQ_KSUB = 256
N_PROBE = 16
FETCH = 512
ADC_B = 128             # adc_topk's main-path shape: B queries, k = 100
ADC_K = 100
RECALL_FLOOR = 0.95     # the JAX package recorded 0.977 here
# phase 4's residual projection and full scans (BENCH_SIFT.json: the JAX
# package's RP read 0.9485 / 0.9678 / 0.9874 at n_probe 8 / 32 / all, at
# spill 2; its residual PQ full scan 0.7954 at fetch 128, spill 1, OPQ 4)
RP_DIMS = 128
RP_PROBES = (8, 32)     # each held to its probe ceiling (spill 1) less 0.03
RP_CEIL_SLACK = 0.03
RP_FETCH = 128
RP_FULL_FETCH = 256
RP_FULL_FLOOR = 0.95
PQ_SCAN_FETCH = 128
PQ_SCAN_FLOOR = 0.77
ADC_CHECK_B = 16        # queries of the biased adc_topk's plain check
# phase 5: HNSW at 1M x 768 (scripts/exp_wide_final.py:38-76)
HNSW_N = 1_000_000
HNSW_DIM = 768
HNSW_M = 16
HNSW_EFC = 200
HNSW_LMAX = 5
HNSW_INSERT = 16384     # the last rows, streamed in after the bulk build
INSERT_BATCH = 1024
SELF_CHECK = 1000       # inserted rows that must be their own top-1
N_DELETE = 100
WIDE_DIMS = 128
WIDE_SEEDS = 16384
WIDE_EF = 1280          # bucketed to the pool width P = 2048
WIDE_F = 224
WIDE_T = 10
CLASSIC_EF = 400
FILTER_EVERY = 10       # 10 % selectivity
WIDE_FLOOR = 0.95       # the JAX package recorded 0.9591 (EXP_WIDE_FINAL)
CLASSIC_FLOOR = 0.70    # README: 0.775 at ef = 400 on an older graph
# phase 5's PQ / RP traversals, PQ-scored wide beam and the inline tables
# with the pool-free beam (BENCH_1M.json, the JAX package's readings less
# 0.02-0.03: RP 0.7841 / 0.9006 at ef 400 / 600, OPQ classic 0.6596, wide
# PQ 0.9542, beam 0.9196 / 0.9486 at F 224 / 320)
HNSW_RP_EFS = {400: 0.76, 600: 0.88}
HNSW_PQ_EF, HNSW_PQ_FLOOR = 400, 0.63
HNSW_OPQ_ITERS = 8
WIDE_PQ = dict(ef=1536, frontier=256, steps=10, rerank_k=1536)
WIDE_PQ_FLOOR = 0.93
INLINE_DIMS = 120       # scripts/bench_1m.py:309
BEAM_T, BEAM_HIST = 12, 2
BEAM_FLOORS = {224: 0.90, 320: 0.92}
PERSIST_Q = 200         # queries of the PQ / RP reload comparison
# phase 6: the services at the config.yaml deployment
SVC_N = 1_000_000       # config.yaml: vector_db.capacity
SVC_DIM = 384           # all-MiniLM-L6-v2 (config.yaml: embedding.dimension)
SVC_QUERIES = 1000
SVC_BATCH = 5000        # scripts/bench_tiered.py's batch
SVC_BATCHES = 2          # streamed batches (phase 11's bench_tiered streams 19)
SVC_SINGLE = 20         # single documents past the threshold (sync save)
SVC_DELETE = 100
SVC_TAGS = 10           # metadata {"tag": id % 10}: a 10 % filter
SVC_SCAN_THRESHOLD = 256
SVC_WIDE_B = 64
SVC_SINGLE_Q = 200
SVC_CHECKED = 20        # single queries held against the direct call
SVC_MIN_SIZE = 4096     # index.wide.min_size and index.pq.min_size
SVC_SMALL_N = 100_000   # step e: the flat and IVF services
SVC_IVF_K = 256
SVC_PQ_M = 16
# the phase's storage content / metadata field widths. Every record here
# ({"tag": t}, no content) fits in 64. The reference's 10,240 / 5,120
# characters make 61,448-byte records, a 61 GB metadata file at 1M rows,
# whose ingest and restart take more time than the phase has; phase 11's
# bench_tiered and bench_api run 100,000 rows at those widths
SVC_FIELD_CHARS = 64
SVC_HTTP = {"embed": 5, "batch_docs": 1, "batch_docs_size": 50,
            "search": 50, "search_batch": 5, "health": 20, "stats": 5}
SCAN_FLOOR = 0.97
SVC_WIDE_FLOOR = 0.7378  # 0.02 under the wide route's first reading, 0.7578
SVC_WIDE_EFS = (400, 1280)  # search_batch_wide efs read beside the route's
# phase 7: autotune and sharding at the same deployment
AT_TARGET = 0.95        # index.autotune.target_recall
AT_SAMPLE = 128         # index.autotune.sample (calibration queries; the
                        # default 256 cut to keep the smoke in its time)
AT_BATCHES = (1000, 64, 1)  # routed batch sizes: buckets 1024, 64 and 8
AT_SINGLE_Q = 200       # single queries of the B = 1 routed recall
AT_SLACK = 0.02         # a routed recall may trail its decision's target
SH_SHARDS = 4           # shards of the sharded indexes, on one card
SH_BATCHES = 2          # streamed insert batches of the sharded HNSW
SH_SEEDS = 1024         # wide seeds a shard (4,096 over the four)
SH_CLASSIC_EFS = (50, 400)
SH_BEAM = dict(frontier=224, steps=12, hist=2)
SH_SLACK = 0.01         # a sharded recall may trail the unsharded one
SH_IVF_CELLS = 1024
SH_IVF_PROBE = 32
SH_CHECK_B = 100        # queries of the per-shard IVF merge check
# phase 8: the port's headline benchmark (bench_torch.run), bench.py's
# sizes but for the headline corpus, cut from 1,000,000 rows to fit the
# smoke's clock
BENCH_HNSW_N = 100_000
BENCH_HEADLINE_N = 262_144
BENCH_REF_N = 10_000
BENCH_QUERIES = 1000
BENCH_TARGET = 0.95
BENCH_FLOORS = {"bf16_scan": 0.99, "blocksel_3p": 0.999,
                "blocksel_2p": 0.999}   # phase 3's floors of the same modes
# phase 9: the 10M x 768 configuration on one card (scripts/bench_10m.py:
# 47-57) and its sharded form (scripts/dryrun_sharded_10m.py:55-57), run by
# the port's scripts at full size. Each recall is held to the JAX package's
# TPU reading less TEN_M_SLACK (BENCH_10M.json, BENCH_SHARDED_10M.json; the
# sharded one read on a CPU mesh)
TEN_M_N = 10_000_000
TEN_M_SLACK = 0.03
TEN_M_JAX = {8: 0.7997, 16: 0.9805, 32: 0.9865, 64: 0.9886}
TEN_M_ROUTED_FLOOR = 0.95
TEN_M_FILTERED_JAX = 0.9809
TEN_M_SHARDED_JAX = 0.99375
TEN_M_CHECK_B = 8       # queries of the filtered block_min check
TEN_M_SLICE = 100       # queries a slice of the full-width block_min check
# phase 10: the benchmark scripts of BASELINE configs 3 and 4, at full size
P10_N = 1_000_000
P10_SLACK = 0.03        # a recall may trail the JAX package's reading by this
P10_JAX = ("BENCH_SIFT.json", "BENCH_PQ.json", "BENCH_1M.json",
           "BENCH_LATENCY.json")
P10_SCRIPTS = ("bench_sift_torch", "bench_pq_torch", "bench_1m_torch",
               "bench_latency_torch")
P10_IVF_K = 4096
P10_B = 1000            # queries of the 1M x 768 corpus
P10_SIFT_Q = 256        # the latency benchmark's SIFT queries
_SHARED = {}            # phases 4 and 5 leave their corpora here for 10
# phase 11: the last four JAX drivers, at the JAX scripts' sizes
P11_SCRIPTS = ("bench_insert_torch", "bench_tiered_torch",
               "bench_sharded_torch", "bench_api_torch")
P11_JAX = ("BENCH_INSERT.json", "BENCH_TIERED.json", "BENCH_SHARDED.json",
           "BENCH_API.json")
P11_INSERT_BASE = 10_000
P11_TIERED_N = 100_000
P11_SHARDED_N = 4_000_000
P11_SHARDED_HNSW = 262_144
P11_API_DOCS = 100_000
P11_API_QUERIES = 2000
P11_SLACK = 0.03        # a recall may trail the JAX package's reading by this
P11_SELF_CHECK = 1000   # streamed rows of bench_insert held to own top-1
# peaks for the bound (H100 SXM datasheet, at 700 W)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
TF32_TC_FLOPS = 495e12
BF16_TC_FLOPS = 989e12
BOOST_MHZ = None        # the card's max SM clock (nvidia-smi), set in main


def log(*parts) -> None:
    print(*parts, flush=True)


SPAN_MS = 2.0           # cuda_ms: least device span one timing covers
SLEEP_CYCLES_S = 2.0e9  # torch.cuda._sleep cycles a second (~ the SM clock)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``reps``
    spans of CUDA events, each around a loop of back-to-back calls (enough
    for ~SPAN_MS ms, from a first host-clock reading) divided by the count.
    Each span starts behind a device sleep as long as the loop's host time,
    so the host has queued every call before the first runs: a kernel
    shorter than its wrapper's host work is timed by the device, not by
    the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    calls = max(1, math.ceil(SPAN_MS / first_ms))
    head_start = int(calls * first_ms * 1e-3 * SLEEP_CYCLES_S)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(head_start)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def l2_cold(torch, fn, *args):
    """A call of ``fn`` that reads its inputs from HBM, not from L2: it
    cycles over copies of ``args`` (tensors) whose bytes together pass 3x
    the L2 size, so a copy's lines are gone before its next call. For
    inputs that fit in L2, which back-to-back calls on one set would
    otherwise read from there."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    nbytes = sum(a.numel() * a.element_size() for a in args)
    sets = [args] + [tuple(a.clone() for a in args)
                     for _ in range(math.ceil(3 * l2 / nbytes) - 1)]
    turn = itertools.cycle(sets)
    return lambda: fn(*next(turn))


def bound(nbytes: float, ops: float, peak: float):
    """(ms, what sets it): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def set_bound(kernel, nbytes, ops, peak, library_ms=None) -> None:
    kernel["bound_ms"], kernel["bound_by"] = bound(nbytes, ops, peak)
    kernel["library_ms"] = library_ms


def terms(q, x_sq):
    """l2_topk's per-query term size: ||q||^2 + max ||x||^2."""
    return ((q * q).sum(-1) + x_sq.max()).cpu().numpy()


def block_terms(q, tab, xsq):
    """The block scans' term size per output row (query, block): max
    |xsq_eff live| + 2 ||q|| max ||x||."""
    live = xsq[xsq < LIVE]
    top = live.abs().max() if live.numel() else xsq.new_zeros(())
    s = top + 2 * q.norm(dim=1) * tab.float().norm(dim=1).max()
    return np.repeat(s.cpu().numpy(), -(-tab.shape[0] // 128))


def check_sorted(name, got, want) -> float:
    """sorted_topk against its plain version run for one more column: keys
    equal exactly; payloads equal as a multiset within each run of equal
    keys (a run that continues past the cut only by its keys). Returns the
    max abs key difference (0)."""
    gk, gv = got[0].float().cpu().numpy(), got[1].cpu().numpy()
    wk, wv = want[0].float().cpu().numpy(), want[1].cpu().numpy()
    topk = gk.shape[1]
    if not np.array_equal(gk, wk[:, :topk]):
        raise AssertionError(f"{name}: keys differ from the plain version")
    cut = (wk[:, topk:topk + 1] == wk[:, topk - 1:topk]
           if wk.shape[1] > topk else np.zeros((gk.shape[0], 1), bool))
    keep = ~((gk == gk[:, -1:]) & cut)
    for r in range(gk.shape[0]):
        a = np.lexsort((gv[r][keep[r]], gk[r][keep[r]]))
        b = np.lexsort((wv[r, :topk][keep[r]], wk[r, :topk][keep[r]]))
        if not np.array_equal(gv[r][keep[r]][a], wv[r, :topk][keep[r]][b]):
            raise AssertionError(f"{name}: payloads differ within a run of "
                                 "equal keys")
    return float(np.abs(gk - wk[:, :topk]).max(initial=0.0))


def check_topk(name, got_v, got_i, want_v, want_i, group: int,
               scale=0.0) -> float:
    """Values within tolerance, equal sentinels, ids equal wherever a value
    is apart from its neighbours (within groups of ``group`` ascending
    entries). A top-k list's want may carry one more column than got: the
    (k+1)-th value, so that a tie across the list's end is not read as a
    difference. ``scale``: per-row term size, [rows] or scalar. Returns the
    max abs error over live values."""
    gv, wv = got_v.cpu().double().numpy(), want_v.cpu().double().numpy()
    gv = gv.reshape(-1, group)
    wv = wv.reshape(gv.shape[0], -1)
    if wv.shape[1] not in (group, group + 1):
        raise AssertionError(f"{name}: {group} columns against "
                             f"{wv.shape[1]}")
    after = wv[:, group:]              # the (k+1)-th value, or nothing
    wv = wv[:, :group]
    scale = np.broadcast_to(np.asarray(scale, np.float64).reshape(-1, 1),
                            (wv.shape[0], 1))
    live = wv < LIVE
    if not np.array_equal(live, gv < LIVE):
        raise AssertionError(f"{name}: live/sentinel entries differ")
    if not np.array_equal(gv[~live], wv[~live]):
        raise AssertionError(f"{name}: sentinel values differ")
    err = np.abs(gv - wv)[live]
    tol = ATOL + RTOL * (np.abs(wv) + scale)
    if (np.abs(gv - wv) > tol)[live].any():
        raise AssertionError(f"{name}: values differ, max abs err "
                             f"{err.max()}")
    if got_i is None:
        return float(err.max(initial=0.0))
    gi = got_i.cpu().numpy().reshape(-1, group)
    wi = want_i.cpu().numpy().reshape(gi.shape[0], -1)[:, :group]
    gap = np.abs(np.diff(np.concatenate([wv, after], axis=1), axis=1))
    apart = np.ones(wv.shape, bool)
    apart[:, 1:] &= gap[:, :group - 1] > tol[:, 1:]
    apart[:, :-1] &= gap[:, :group - 1] > tol[:, :-1]
    if after.shape[1]:
        apart[:, -1] &= gap[:, -1] > tol[:, -1]
    if not np.array_equal(gi[apart], wi[apart]):
        bad = int((gi[apart] != wi[apart]).sum())
        raise AssertionError(f"{name}: {bad} ids differ between apart values")
    return float(err.max(initial=0.0))


def phase_kernels(torch, dev, kernels):
    """Phase 2: every kernel against its plain version on the card."""
    from vector_db_tpu_torch.ops.cuda.block_min import (
        block_min_plain, block_min_scan)
    from vector_db_tpu_torch.ops.cuda.block_topm import (
        block_topm_plain, block_topm_scan)
    from vector_db_tpu_torch.ops.cuda.adc_probe import (
        adc_probe_plain, adc_probe_scores)
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk, adc_topk_plain
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk, l2_topk_plain
    from vector_db_tpu_torch.ops.cuda.sorted_topk import (
        sorted_topk, sorted_topk_plain)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def l2_case(n, d, b, k, dtype, invalid_every=9, dups=5, valid_rows=None):
        x = randn(n, d)
        x[1:dups] = x[0]
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[::invalid_every] = False
        if valid_rows is not None:
            valid[valid_rows:] = False
        q = randn(b, d)
        q[0] = x[0]
        x_sq = (x * x).sum(-1)
        tab = x.to(dtype)
        got = l2_topk(q, tab, valid, k, x_sq=x_sq)
        want = l2_topk_plain(q, tab, valid, k + 1, x_sq)
        return check_topk(f"l2_topk {dtype} n={n} b={b} k={k}", *got, *want,
                          group=k, scale=terms(q, x_sq))

    def block_case(n, ds, b, m, dtype, invalid_every=13, dups=200):
        tab = randn(n, ds)
        tab[1:dups] = tab[0]
        xsq = torch.rand(n, generator=gen, device=dev) * 10
        xsq[1:dups] = xsq[0]
        if n > 256:  # equal rows in other threads and quads of block 1
            tab[[131, 194, 255]] = tab[3].clone()
            xsq[[131, 194, 255]] = xsq[3].clone()
        xsq[::invalid_every] = 2e38
        q = randn(b, ds)
        tab = tab.to(dtype)
        vals, rows = block_topm_scan(q, tab, xsq, m=m)
        # one more column: a near-tie across the m-th place is no difference
        pv, pr = block_topm_plain(q, tab, xsq, min(m + 1, 128))
        scale = block_terms(q, tab, xsq)
        e1 = check_topk(f"block_topm {dtype} n={n} ds={ds} b={b} m={m}",
                        vals, rows, pv, pr, group=m, scale=scale)
        e2 = check_topk(f"block_min {dtype} n={n} ds={ds} b={b}",
                        block_min_scan(q, tab, xsq), None,
                        block_min_plain(q, tab, xsq), None, group=1,
                        scale=scale)
        return e1, e2

    def block_ties(dtype, b):
        """Copies of one row are the best rows of their blocks: rows 3, 66
        and 127 (other threads and quads of one block) come out in row
        order with equal values, and copies in other blocks (other CTAs)
        score the same value."""
        n, m = 4096 + 70, 4
        x = randn(n, 128)
        copies = [3, 66, 127, 130, 255, 1000, 3000, 4100]
        x[copies] = x[copies[0]].clone()
        xsq = torch.full((n,), 1e4, device=dev)
        xsq[copies] = 0.0
        vals, rows = block_topm_scan(randn(b, 128), x.to(dtype), xsq, m=m)
        vals = vals.view(b, -1, m).cpu()
        rows = rows.view(b, -1, m).cpu()
        top = vals[:, 0, :1]
        if not ((rows[:, 0, :3] == torch.tensor([3, 66, 127])).all()
                and (rows[:, 1, :2] == torch.tensor([130, 255])).all()
                and (rows[:, [7, 23, 32], 0]
                     == torch.tensor([1000, 3000, 4100])).all()
                and (vals[:, 0, :3] == top).all()
                and (vals[:, 1, :2] == top).all()):
            raise AssertionError(f"block_topm {dtype} b={b}: a tie did not "
                                 "go to the lower row")
        if ((vals[:, [7, 23, 32], 0] - top).abs()
                > ATOL + RTOL * top.abs()).any():
            raise AssertionError(f"block_topm {dtype} b={b}: copies in other "
                                 "blocks score other values")

    def adc_probe_case(b, cells, width, m, ksub, offset=0):
        """P = cells * width slots, live for a random prefix of each cell
        (the padded cell table's long dead runs); codes at ``offset``
        bytes from an aligned base."""
        p = cells * width
        lut = randn(b, m, ksub) ** 2
        flat = torch.randint(0, ksub, (b * p * m + offset,), generator=gen,
                             device=dev, dtype=torch.uint8)
        codes = flat[offset:].view(b, p, m)
        codes[:, 1] = codes[:, 0]
        corr = randn(b, p)
        live = torch.randint(0, width + 1, (b, cells, 1), generator=gen,
                             device=dev)
        valid = (torch.arange(width, device=dev) < live).reshape(b, p)
        got = adc_probe_scores(lut, codes, corr, valid)
        want = adc_probe_plain(lut, codes, corr, valid)
        return check_topk(f"adc_probe b={b} p={p} m={m} ksub={ksub} "
                          f"offset={offset}", got, None, want, None,
                          group=p, scale=adc_terms(lut, corr))

    def adc_topk_case(n, m, ksub, b, k, dtype, valid_rows=None,
                      wild=False):
        """``wild``: int32 codes in [-300, ksub + 300), which clamp (never
        wrap): the kernel gives the clamped uint8 table's result exactly."""
        lut = randn(b, m, ksub) ** 2
        lo, hi = (-300, ksub + 300) if wild else (0, ksub)
        codes = torch.randint(lo, hi, (n, m), generator=gen, device=dev,
                              dtype=dtype)
        codes[1:6] = codes[0]
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[::9] = False
        if valid_rows is not None:
            valid[valid_rows:] = False
        got = adc_topk(lut, codes, valid, k)
        want = adc_topk_plain(lut, codes, valid, k + 1)
        name = (f"adc_topk {dtype} n={n} m={m} ksub={ksub} b={b} k={k}"
                f"{' wild codes' if wild else ''}")
        if wild:
            same = adc_topk(lut, codes.clamp(0, ksub - 1).to(torch.uint8),
                            valid, k)
            if not (torch.equal(got[0], same[0])
                    and torch.equal(got[1], same[1])):
                raise AssertionError(f"{name}: differs from the clamped "
                                     "uint8 table")
        return check_topk(name, *got, *want, group=k)

    def adc_ties(b, k):
        """Copies of the best row in one warp, in other tiles and in other
        corpus splits come out in row order; no valid row gives pads."""
        n = 300000
        lut = randn(b, 16, 256) ** 2 + 1.0
        lut[:, :, 0] = 0.0
        codes = torch.randint(1, 256, (n, 16), generator=gen, device=dev,
                              dtype=torch.uint8)
        copies = [7, 8, 300, 41000, 150001, n - 1]
        codes[copies] = 0
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        d, ids = adc_topk(lut, codes, valid, k)
        run = min(k, len(copies))
        if ids[:, :run].cpu().tolist() != [copies[:run]] * b or \
                (d[:, :run] != 0).any():
            raise AssertionError(f"adc_topk b={b} k={k}: a tie did not go "
                                 "to the lower row")
        d, ids = adc_topk(lut, codes, torch.zeros_like(valid), k)
        if not ((d >= 3e38).all() and (ids == -1).all()):
            raise AssertionError("adc_topk: no valid row, yet a live entry")

    def sorted_case(b, n, topk, dtype, presorted=0, ties=False):
        d = randn(b, n)
        if ties:
            d = (d * 4).round()
        if presorted:
            d[:, :presorted] = d[:, :presorted].sort(dim=1).values
        d = d.to(dtype)
        d[:, 1::7] = 3.0e38
        v = torch.randint(0, 1 << 30, (b, n), generator=gen, device=dev,
                          dtype=torch.int32)
        got = sorted_topk(d, v, topk, presorted=presorted)
        want = sorted_topk_plain(d, v, min(topk + 1, n))
        name = (f"sorted_topk {dtype} b={b} n={n} topk={topk} "
                f"presorted={presorted} ties={ties}")
        e = check_sorted(name, got, want)
        ms = cuda_ms(torch, lambda: sorted_topk(d, v, topk,
                                                presorted=presorted))
        plain_ms = cuda_ms(torch, lambda: sorted_topk_plain(d, v, topk))
        lib_ms = cuda_ms(torch, lambda: torch.gather(v, 1, torch.topk(
            d.float(), topk, dim=1, largest=False).indices))
        log(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"torch.topk + gather {lib_ms:.3f} ms, max abs err {e}")
        return e

    def sorted_edge(case, dtype):
        """sorted_topk where the select and the cut could go wrong, at the
        wide-beam shape (6 rows of 9,216 keys -> 2,048) or the widest row
        a CTA holds (16,384 -> 8,192); exact equality."""
        b, n, topk = 6, 9216, 2048
        d = randn(b, n)
        if case == "ties_across_cut":
            d = (d * 2).round()
        elif case == "all_equal":
            d = torch.full_like(d, 1.5)
        elif case == "signed_zeros":
            zero = torch.zeros_like(d)
            d = torch.where(d > 0, zero, -zero)
            d[:, ::5] = randn(b, d[:, ::5].shape[1])
        elif case == "big_at_cut":
            d[:, :n - topk + 5] = 3.0e38
        elif case == "max_width":
            n, topk = 16384, 8192
            d = randn(b, n)
        d = d.to(dtype)
        v = torch.randint(0, 1 << 30, (b, n), generator=gen, device=dev,
                          dtype=torch.int32)
        got = sorted_topk(d, v, topk)
        want = sorted_topk_plain(d, v, topk)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(f"sorted_topk {case} {dtype}: differs "
                                 "from the stable sort")

    def l2_ties(dtype, k, b):
        """Copies of one row in two tiles of one CTA and in other splits:
        the lower rows come first, a cut keeps the lowest (b = 3: lists in
        shared memory; b = 130: in registers)."""
        n = 40000
        x = randn(n, 96)
        copies = [7, 200, 300, 9000, 21000, 39999]
        x[copies] = x[copies[0]].clone()
        q = x[copies[0]][None].repeat(b, 1).clone()
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        _, ids = l2_topk(q, x.to(dtype), valid, k, x_sq=(x * x).sum(-1))
        run = min(k, len(copies))
        if ids[:, :run].cpu().tolist() != [copies[:run]] * b:
            raise AssertionError(f"l2_topk {dtype} k={k}: a tie did not go "
                                 "to the lower row")

    def l2_no_valid(dtype):
        x = randn(3000, 64)
        d, i = l2_topk(randn(5, 64), x.to(dtype),
                       torch.zeros(3000, dtype=torch.bool, device=dev), 10,
                       x_sq=(x * x).sum(-1))
        if not ((d >= 3e38).all() and (i == -1).all()):
            raise AssertionError(f"l2_topk {dtype}: no valid row, yet a "
                                 "live entry")

    err = {"l2_topk": 0.0, "block_topm": 0.0, "block_min": 0.0,
           "adc_probe": 0.0, "adc_topk": 0.0, "sorted_topk": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for case in ("ties_across_cut", "all_equal", "signed_zeros",
                     "big_at_cut", "max_width"):
            sorted_edge(case, dtype)
    log("phase 2 sorted_topk select edges ok (ties across the cut, one "
        "key, +-0.0, BIG at the cut, 16,384 -> 8,192): equal to the stable "
        "sort")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (128, 768):
            for k in (1, 10, 64, 65, 200, 256):  # query groups 128, 64, 32
                err["l2_topk"] = max(err["l2_topk"],
                                     l2_case(4096 + 77, d, 130, k, dtype))
        for k in (2, 10):
            for b in (3, 130):
                l2_ties(dtype, k, b)
        l2_no_valid(dtype)
    log(f"phase 2 l2_topk widths, ties and empty masks ok: max abs err "
        f"{err['l2_topk']}")
    for args, kw in (((1, 9216, 2048, torch.bfloat16), {}),       # B = 1
                     ((7, 1003, 999, torch.float32), {}),         # ragged n
                     ((3, 40000, 3000, torch.float32), {}),       # n > 16384
                     ((2, 70000, 8192, torch.bfloat16), {}),
                     ((5, 9216, 2048, torch.bfloat16), {"presorted": 2048}),
                     ((6, 5000, 2500, torch.bfloat16), {"ties": True}),
                     ((4, 20000, 1000, torch.float32), {"ties": True})):
        err["sorted_topk"] = max(err["sorted_topk"], sorted_case(*args, **kw))
    log(f"phase 2 sorted_topk edge shapes ok: keys and payloads equal the "
        f"plain version's, max abs err {err['sorted_topk']}")
    for m in (4, 6, 8, 16, 32):  # 6: the generic m
        for ksub in (16, 256):
            for b, cells, width, offset in ((1, 1, 70, 0), (7, 16, 63, 0),
                                            (5, 16, 113, 1)):
                err["adc_probe"] = max(err["adc_probe"], adc_probe_case(
                    b, cells, width, m, ksub, offset))
            for dtype in (torch.uint8, torch.int32):
                for n, b, k, vr in ((1000 + 7, 1, 1, None),
                                    (5000 + 70, 70, 100, None),
                                    (5000 + 70, 128, 256, None),
                                    (300, 3, 256, 200)):  # k > valid rows
                    err["adc_topk"] = max(err["adc_topk"], adc_topk_case(
                        n, m, ksub, b, k, dtype, valid_rows=vr))
            err["adc_topk"] = max(err["adc_topk"], adc_topk_case(
                20000 + 5, m, ksub, 70, 50, torch.int32, wild=True))
    # many subspaces: 4-bit PQ of 768-d rows (192 x 4 bits), and a LUT that
    # leaves room for one query and a shorter tile
    for m, ksub in ((192, 16), (160, 256)):
        for dtype in (torch.uint8, torch.int32):
            err["adc_topk"] = max(err["adc_topk"], adc_topk_case(
                3000 + 7, m, ksub, 5, 10, dtype))
    # long lists: k past 256 (a CTA holds fewer queries), to the 2048 that
    # the full-scan IVF-PQ's fetch may reach
    for b, k, vr in ((1, 257, None), (9, 512, None), (130, 1024, None),
                     (70, 2048, None), (5, 2048, 1500)):
        err["adc_topk"] = max(err["adc_topk"], adc_topk_case(
            30000 + 11, 16, 256, b, k, torch.uint8, valid_rows=vr))
    for m, ksub in ((240, 16), (200, 256)):
        err["adc_probe"] = max(err["adc_probe"], adc_probe_case(
            3, 4, 75, m, ksub))
    for b in (3, 128):
        for k in (2, 10):
            adc_ties(b, k)
    log(f"phase 2 adc edge shapes ok (m 4, 6, 8, 16, 32, 160-240; ksub 16, "
        f"256; B 1, 70, 128; k 1, 100, 256, 257-2048; ragged N and P; dead "
        f"runs; codes off alignment; int32 codes out of range clamp; ties "
        f"across tiles and splits; no valid row): max abs err {err}")
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, b, k, vr in ((1000, 64, 1, 10, None),
                               (5000 + 70, 200, 70, 100, None),
                               (300, 32, 5, 256, 200),  # k > valid rows
                               (4096, 768, 130, 16, None)):
            err["l2_topk"] = max(err["l2_topk"],
                                 l2_case(n, d, b, k, dtype, valid_rows=vr))
        for n, ds, b, m in ((1000, 128, 1, 2), (4096 + 70, 200, 70, 4),
                            (300, 32, 5, 1), (4096 + 70, 100, 1000, 16),
                            (1000, 128, 70, 128), (300, 200, 1000, 1),
                            (4096 + 70, 32, 70, 128),
                            (4096 + 70, 128, 1000, 2),
                            (1000, 300, 70, 2)):  # bf16 past the wgmma path
            e1, e2 = block_case(n, ds, b, m, dtype)
            err["block_topm"] = max(err["block_topm"], e1)
            err["block_min"] = max(err["block_min"], e2)
        for b in (3, 130):
            block_ties(dtype, b)
    log(f"phase 2 edge shapes and block ties ok: max abs err {err}")

    # lists past the kernels' own, as the scans run them: passes, each
    # launch from the last one's final (value, row) pair; a run of tied rows
    # across the passes' cuts, and k past the valid rows
    from vector_db_tpu_torch.ops.cuda.adc_scan import MAX_K as ADC_MAX_K
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk_long
    from vector_db_tpu_torch.ops.exact import approx_search_tiled, exact_search

    def passes_case(name, kernel, width, k, call, one, want, scale):
        """``call`` at k by passes against the plain version; its time
        beside ``one``, a single launch at the kernel's width."""
        before = kernel.launches
        got = call()
        launched = kernel.launches - before
        if launched != -(-k // width):
            raise AssertionError(f"{name}: {launched} launches")
        e = check_topk(f"{name} ({launched} launches)", *got, *want(),
                       group=k, scale=scale)
        log(f"{name}: {launched} launches {cuda_ms(torch, call):.3f} ms, "
            f"one launch at k = {width} {cuda_ms(torch, one):.3f} ms; "
            f"max abs err {e}")
        return e

    for n, d, b, k, vr in ((30000 + 11, 200, 70, 600, None),
                           (3000, 64, 5, 2900, 2000)):
        x = randn(n, d)
        x[100:700] = x[0]
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[::9] = False
        if vr is not None:
            valid[vr:] = False
        q = x[:1] + 0.01 * randn(b, d)
        x_sq = (x * x).sum(-1)
        for tab, scan in ((x, exact_search), (x.to(torch.bfloat16),
                                              approx_search_tiled)):
            err["l2_topk"] = max(err["l2_topk"], passes_case(
                f"l2_topk {tab.dtype} n={n} b={b} k={k} by passes",
                l2_topk, 256, k,
                lambda: scan(q, tab, valid, k, x_sq=x_sq),
                lambda: l2_topk(q, tab, valid, 256, x_sq=x_sq),
                lambda: l2_topk_plain(q, tab, valid, k + 1, x_sq),
                terms(q, x_sq)))
    for n, b, k, vr in ((100000 + 3, 70, 2560, None), (6000, 5, 4500, 3000)):
        lut = randn(b, 16, 256) ** 2
        codes = torch.randint(0, 256, (n, 16), generator=gen, device=dev,
                              dtype=torch.uint8)
        codes[200:3000] = codes[5]
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[::9] = False
        if vr is not None:
            valid[vr:] = False
        err["adc_topk"] = max(err["adc_topk"], passes_case(
            f"adc_topk n={n} b={b} k={k} by passes", adc_topk, ADC_MAX_K, k,
            lambda: adc_topk_long(lut, codes, valid, k),
            lambda: adc_topk(lut, codes, valid, ADC_MAX_K),
            lambda: adc_topk_plain(lut, codes, valid, k + 1), 0.0))
    log(f"phase 2 long lists by passes ok (l2_topk k 600, 2900; adc_topk k "
        f"2560, 4500; tied runs across the cuts, k past the valid rows): "
        f"max abs err {err}")

    # the main path's shapes
    q = randn(B, DIM)
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = randn(N_MAIN, DIM)
        x_sq = (x * x).sum(-1)
        tab = x.to(dtype)
        del x
        valid = torch.ones(N_MAIN, dtype=torch.bool, device=dev)
        valid[::97] = False
        got = l2_topk(q, tab, valid, K, x_sq=x_sq)
        want = l2_topk_plain(q, tab, valid, K + 1, x_sq)
        e = check_topk(f"l2_topk {label} main", *got, *want, group=K,
                       scale=terms(q, x_sq))
        err["l2_topk"] = max(err["l2_topk"], e)
        ms = cuda_ms(torch, lambda: l2_topk(q, tab, valid, K, x_sq=x_sq))
        plain_ms = cuda_ms(torch, lambda: l2_topk_plain(q, tab, valid, K,
                                                        x_sq))
        qc = q.to(dtype)
        mm_ms = cuda_ms(torch, lambda: torch.matmul(qc, tab.T))
        log(f"l2_topk {label} table N={N_MAIN} d={DIM} B={B} k={K}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, max abs err {e}")
        log(f"torch.matmul [{B},{DIM}] x [{DIM},{N_MAIN}] in {label} "
            f"(TF32 off; the product alone, not the same function): "
            f"{mm_ms:.3f} ms")
        rec = kernels["l2_topk" if label == "f32" else "l2_topk_bf16"]
        rec.update(ms=ms, plain_ms=plain_ms, max_abs_err=e)
        # reads: table, its norms and mask, the queries; the k-lists out.
        # f32 as 3xTF32 is three products at the TF32 rate
        el = 4 if label == "f32" else 2
        set_bound(rec, N_MAIN * DIM * el + N_MAIN * 5 + B * DIM * 4
                  + B * K * 8,
                  (3.0 if label == "f32" else 1.0) * 2.0 * B * N_MAIN * DIM,
                  TF32_TC_FLOPS if label == "f32" else BF16_TC_FLOPS)
        del tab, x_sq, valid, got, want

    tab = randn(N_MAIN, DS).to(torch.bfloat16)
    xsq = torch.rand(N_MAIN, generator=gen, device=dev) * 10
    xsq[::97] = 2e38
    qs = randn(B, DS)
    vals, rows = block_topm_scan(qs, tab, xsq, m=M_2P)
    pv, pr = block_topm_plain(qs, tab, xsq, M_2P + 1)
    scale = block_terms(qs, tab, xsq)
    e = check_topk("block_topm main", vals, rows, pv, pr, group=M_2P,
                   scale=scale)
    err["block_topm"] = max(err["block_topm"], e)
    mins = block_min_scan(qs, tab, xsq)
    e2 = check_topk("block_min main", mins, None,
                    block_min_plain(qs, tab, xsq), None, group=1,
                    scale=scale)
    err["block_min"] = max(err["block_min"], e2)
    del vals, rows, pv, pr, mins
    qc = (qs * -2.0).to(torch.bfloat16)
    mm_ms = cuda_ms(torch, lambda: torch.matmul(qc, tab.T))
    log(f"torch.matmul [{B},{DS}] x [{DS},{N_MAIN}] in bf16 (the block "
        f"scans' product alone, not the same function): {mm_ms:.3f} ms")
    for name, fn, plain in (
            ("block_topm", lambda: block_topm_scan(qs, tab, xsq, m=M_2P),
             lambda: block_topm_plain(qs, tab, xsq, M_2P)),
            ("block_min", lambda: block_min_scan(qs, tab, xsq),
             lambda: block_min_plain(qs, tab, xsq))):
        ms, plain_ms = cuda_ms(torch, fn), cuda_ms(torch, plain)
        kernels[name].update(ms=ms, plain_ms=plain_ms)
        out = (N_MAIN // 128) * B * (M_2P * 8 if name == "block_topm" else 4)
        set_bound(kernels[name], N_MAIN * (DS * 2 + 4) + B * DS * 4 + out,
                  2.0 * B * N_MAIN * DS, BF16_TC_FLOPS)
        log(f"{name} bf16 table N={N_MAIN} ds={DS} B={B}"
            f"{' m=%d' % M_2P if name == 'block_topm' else ''}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{kernels[name]['bound_ms']:.4f} ms")
    # adc_topk at the main path's shape (PQCodec.adc_search's int32 codes)
    lut = randn(ADC_B, PQ_M, PQ_KSUB) ** 2
    codes = torch.randint(0, PQ_KSUB, (N_MAIN, PQ_M), generator=gen,
                          device=dev, dtype=torch.int32)
    valid = torch.ones(N_MAIN, dtype=torch.bool, device=dev)
    valid[::97] = False
    got = adc_topk(lut, codes, valid, ADC_K)
    want = adc_topk_plain(lut, codes, valid, ADC_K + 1)
    e = check_topk("adc_topk main", *got, *want, group=ADC_K)
    err["adc_topk"] = max(err["adc_topk"], e)
    ms = cuda_ms(torch, lambda: adc_topk(lut, codes, valid, ADC_K))
    plain_ms = cuda_ms(torch, lambda: adc_topk_plain(lut, codes, valid,
                                                     ADC_K))
    kernels["adc_topk"].update(ms=ms, plain_ms=plain_ms)
    # reads: int32 codes, mask, LUTs; one f32 add per (query, row, subspace)
    set_bound(kernels["adc_topk"],
              N_MAIN * (PQ_M * 4 + 1) + ADC_B * PQ_M * PQ_KSUB * 4
              + ADC_B * ADC_K * 8, float(ADC_B) * N_MAIN * PQ_M, F32_FLOPS)
    # the lookup floor: B * N * m shared-memory lookups of 4 bytes at one
    # 32-lane wavefront (128 bytes) per SM per clock, at the boost clock
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lookups = float(ADC_B) * N_MAIN * PQ_M
    floor_ms = lookups / (32.0 * sms * BOOST_MHZ * 1e6) * 1e3
    log(f"adc_topk int32 codes N={N_MAIN} m={PQ_M} ksub={PQ_KSUB} B={ADC_B} "
        f"k={ADC_K} (the narrowing to uint8 included): kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, max abs err {e}; bound "
        f"{kernels['adc_topk']['bound_ms']:.4f} ms "
        f"({kernels['adc_topk']['bound_by']}); lookup floor {floor_ms:.4f} "
        f"ms ({lookups:.3g} lookups, {sms} SMs at {BOOST_MHZ} MHz), kernel "
        f"at {ms / floor_ms:.2f}x the floor")
    c8 = codes.to(torch.uint8)
    ms_u8 = cuda_ms(torch, lambda: adc_topk(lut, c8, valid, ADC_K))
    log(f"adc_topk uint8 codes (no narrowing pass), same shape: kernel "
        f"{ms_u8:.3f} ms")
    # B off the query group: the last group's CTAs hold padded query slots
    ms_ragged = cuda_ms(torch, lambda: adc_topk(lut[:100], codes, valid,
                                                ADC_K))
    log(f"adc_topk int32 codes, B=100 (the last group of 8 half padded): "
        f"kernel {ms_ragged:.3f} ms, {ms_ragged / ms * 128 / 100:.3f}x "
        f"B=128's time a query")
    del c8
    del lut, codes, valid, got, want
    for name in err:
        kernels[name]["max_abs_err"] = max(err[name],
                                           kernels[name].get("max_abs_err",
                                                             0.0))
    kernels["l2_topk_bf16"]["max_abs_err"] = max(
        kernels["l2_topk_bf16"]["max_abs_err"], err["l2_topk"])
    log(f"phase 2 ok: kernels agree with their plain versions, "
        f"max abs err {err}")


def phase_main_path(torch, kernels):
    """Phase 3: FlatIndex at 1M x 768 in all four precisions."""
    from vector_db_tpu_torch import (
        FlatIndex, InMemoryNodeStorage, Node, embedding_like)
    from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan
    from vector_db_tpu_torch.ops.cuda.block_topm import block_topm_scan
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk

    t0 = time.perf_counter()
    x = embedding_like(CORPUS + B, DIM, seed=1, intrinsic=64, device="numpy")
    queries = np.ascontiguousarray(x[CORPUS:])
    x = x[:CORPUS]
    nodes = [Node(id=i, embedding=x[i]) for i in range(CORPUS)]
    log(f"corpus {CORPUS} x {DIM} and {B} queries made "
        f"({time.perf_counter() - t0:.1f} s, host)")

    wrappers = {"l2_topk": l2_topk, "block_topm": block_topm_scan,
                "block_min": block_min_scan}
    for fn in wrappers.values():
        fn.launches = 0
    l2_topk.launches_bf16 = 0
    torch.cuda.reset_peak_memory_stats()

    storage = InMemoryNodeStorage()
    indexes = {}
    for p in ("f32", "bf16", "blocksel", "blocksel2p"):
        t0 = time.perf_counter()
        idx = FlatIndex(storage=storage, capacity=1 << 20, precision=p,
                        device="cuda")
        for s in range(0, CORPUS, 65536):
            idx.insert_nodes(nodes[s:s + 65536])
        torch.cuda.synchronize()
        assert idx.size == CORPUS
        indexes[p] = idx
        log(f"{p}: inserted {CORPUS} nodes in "
            f"{time.perf_counter() - t0:.1f} s")

    # delete the f32 top-1 of 100 queries; they must never come back
    _, top1 = indexes["f32"].search_batch(queries[:100], 1)
    deleted = sorted(set(top1[:, 0].tolist()))[:100]
    for idx in indexes.values():
        for i in deleted:
            idx.delete_node(i)
    log(f"deleted {len(deleted)} ids")

    allowed = set(range(0, CORPUS, 3))
    for p, idx in indexes.items():
        t0 = time.perf_counter()
        _, ids = idx.search_batch(queries[:8], K, filter_ids=allowed)
        if not (set(ids[ids >= 0].tolist()) <= allowed) or (ids < 0).any():
            raise AssertionError(f"{p}: filtered search left the filter")
        log(f"{p}: filter_ids query ok, {time.perf_counter() - t0:.2f} s "
            "with the mirror build")

    rng = np.random.default_rng(2)
    batches = [queries + 0.01 * rng.standard_normal(queries.shape).astype(
        np.float32) for _ in range(5)]
    results, qps = {}, {}
    for p, idx in indexes.items():  # mirrors were built by the filter query
        results[p] = idx.search_batch(queries, K)
        secs = []
        for i, qb in enumerate(batches):  # 2 warm-ups, 3 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx.search_batch(qb, K)
            torch.cuda.synchronize()
            if i >= 2:
                secs.append(time.perf_counter() - t0)
        qps[p] = B / statistics.median(secs)
        ids = results[p][1]
        if ids.shape != (B, K) or (ids < 0).any() or \
                set(ids.ravel().tolist()) & set(deleted):
            raise AssertionError(f"{p}: bad ids (pad or deleted id)")
        if not np.isfinite(results[p][0]).all():
            raise AssertionError(f"{p}: non-finite distances")
        log(f"{p}: QPS {qps[p]:.1f} (B={B}, k={K}, median of 3 host-clock "
            "reps)")

    counts = {name: fn.launches for name, fn in wrappers.items()}
    # one wrapper, two kernels: over the f32 table and over the bf16 mirror
    counts["l2_topk_bf16"] = l2_topk.launches_bf16
    counts["l2_topk"] -= counts["l2_topk_bf16"]
    peak = torch.cuda.max_memory_allocated()
    for p, idx in indexes.items():
        profile(torch, f"flat {p}", lambda: idx.search_batch(batches[0], K))

    # f32 against float64 ground truth over the live corpus
    live = np.ones(CORPUS, bool)
    live[deleted] = False
    float64_bound("f32", x, queries[:8], results["f32"][1][:8], K, live)
    log("f32 exact against float64 ground truth on 8 queries: ok")

    truth = results["f32"][1]
    floors = {"bf16": 0.99, "blocksel": 0.999, "blocksel2p": 0.999}
    recalls = {}
    for p, floor in floors.items():
        recalls[p] = recall_at(results[p][1], truth)
        if recalls[p] < floor:
            raise AssertionError(f"{p}: recall@{K} {recalls[p]} < {floor}")
    log(f"recall@{K} against the port's f32 scan: {recalls}")
    log(f"QPS: {qps}")
    log(f"peak device memory allocated: {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    log(f"launch counts on the main path: {counts}")
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{name}: no launch on the main path")
        kernels[name]["launches"] = c
    log(f"block scans on the main path: blocksel launched block_min "
        f"{counts['block_min']} times, recall@{K} {recalls['blocksel']} >= "
        f"{floors['blocksel']}; blocksel2p launched block_topm "
        f"{counts['block_topm']} times, recall@{K} {recalls['blocksel2p']} "
        f">= {floors['blocksel2p']} (against the port's f32 scan)")


def adc_terms(lut, corr):
    """Per query: the largest LUT sum plus the largest |corr|."""
    return (lut.amax(-1).sum(-1) + corr.abs().amax(-1)).cpu().numpy()


def recall_at(got, truth) -> float:
    hits = sum(len(set(a) & set(b)) for a, b in
               zip(got.tolist(), truth.tolist()))
    return hits / truth.size


def float64_bound(name, x, queries, ids, k, live=None) -> None:
    """Every returned id lies within (1 + 1e-5) of the float64 k-th
    distance over the live rows of x."""
    q64 = queries.astype(np.float64)
    d64 = np.empty((q64.shape[0], x.shape[0]))
    for s in range(0, x.shape[0], 65536):
        xc = x[s:s + 65536].astype(np.float64)
        d64[:, s:s + 65536] = ((xc * xc).sum(1)[None, :] - 2 * q64 @ xc.T
                               + (q64 * q64).sum(1)[:, None])
    if live is not None:
        d64 = np.where(live[None, :], d64, np.inf)
    d64 = np.sqrt(np.maximum(d64, 0))
    kth = np.sort(d64, axis=1)[:, k - 1]
    got = np.take_along_axis(d64, ids, axis=1)
    if not (got <= (1 + 1e-5) * kth[:, None]).all():
        raise AssertionError(f"{name}: a returned id lies beyond the float64 "
                             "k-th distance")


def phase_ivf_pq(torch, kernels):
    """Phase 4: IVF-PQ at SIFT1M scale, PQCodec's ADC scan, FlatIndex k=300."""
    from vector_db_tpu_torch import (
        FlatIndex, IvfIndex, Node, PQCodec, sift_like)
    from vector_db_tpu_torch.index.ivf import _probe
    from vector_db_tpu_torch.index.pq import _adc_lut
    from vector_db_tpu_torch.ops.cuda.adc_probe import (
        adc_probe_plain, adc_probe_scores)
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk
    from vector_db_tpu_torch.ops.exact import exact_search_tiled

    t0 = time.perf_counter()
    x, queries = sift_like(IVF_N, dim=IVF_DIM, seed=0, queries=B)
    _SHARED["sift"] = (x, queries)      # scripts/bench_sift.py's corpus
    fresh, _ = sift_like(64, dim=IVF_DIM, seed=1)
    log(f"sift_like corpus {IVF_N} x {IVF_DIM} and {B} queries made "
        f"({time.perf_counter() - t0:.1f} s, host)")
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    ivf = IvfIndex(k=IVF_CELLS, device="cuda")
    ivf.build_arrays(range(IVF_N), x, seed=0, iters=20, spill=1,
                     list_cap_alpha=2.0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf.enable_pq(chunks=PQ_M, ksub=PQ_KSUB, opq_iters=4, residual=True)
    torch.cuda.synchronize()
    pq_s = time.perf_counter() - t0
    log(f"IvfIndex(k={IVF_CELLS}).build_arrays: {build_s:.1f} s; "
        f"enable_pq(m={PQ_M}, ksub={PQ_KSUB}, opq_iters=4, residual): "
        f"{pq_s:.1f} s; cells {ivf.get_cluster_stats()}")

    new_ids = list(range(IVF_N, IVF_N + 64))
    for i, nid in enumerate(new_ids):
        ivf.add(Node(id=nid, embedding=fresh[i]))
    qd = torch.from_numpy(queries).cuda()
    _, top1 = exact_search_tiled(qd[:100], ivf._emb, ivf._has_emb, 1)
    deleted = sorted(set(ivf._store.ids_of(top1.cpu().numpy())[:, 0]
                         .tolist()))
    for i in deleted:
        ivf.delete(i)
    log(f"added {len(new_ids)} ids, deleted {len(deleted)} (the exact top-1 "
        "of 100 queries)")

    allowed = set(range(0, IVF_N, 3))
    _, ids = ivf.search_batch(queries[:8], N_PROBE, K, pq=True, fetch=FETCH,
                              filter_ids=allowed)
    if (ids < 0).any() or not set(ids.ravel().tolist()) <= allowed:
        raise AssertionError("ivf-pq: filtered search left the filter")
    log("ivf-pq: filter_ids query ok")

    modes = {"ivf_pq": dict(pq=True, fetch=FETCH), "ivf_flat": {}}
    rng = np.random.default_rng(3)
    batches = [queries + 0.01 * rng.standard_normal(queries.shape).astype(
        np.float32) for _ in range(5)]

    def probe_call(q, **kw):
        return ivf.search_batch(q, N_PROBE, K, **kw)

    results, qps, launched = bench_rows(
        torch, {name: (probe_call, kw) for name, kw in modes.items()},
        batches, queries, (adc_probe_scores, adc_topk, l2_topk))
    counts = {"adc_probe": launched["ivf_pq"]["adc_probe_scores"]}
    probe_row_ms = None
    for name, kw in modes.items():
        rows = profile(torch, name, lambda: ivf.search_batch(
            batches[0], N_PROBE, K, **kw))
        if name == "ivf_pq":
            probe_row_ms = kernel_row_ms(rows, "adc_probe_kernel")
    if counts["adc_probe"] <= 0:
        raise AssertionError("adc_probe: no launch on the IVF-PQ path")
    kernels["adc_probe"]["launches"] = counts["adc_probe"]

    _, truth_slots = exact_search_tiled(qd, ivf._emb, ivf._has_emb, K)
    truth_slots = truth_slots.cpu().numpy()
    truth = ivf._store.ids_of(truth_slots)
    recalls = {name: recall_at(r[1], truth) for name, r in results.items()}
    log(f"recall@{K} against the port's exact scan: {recalls}")
    for name, (d, ids) in results.items():
        if ids.shape != (B, K) or (ids < 0).any() or \
                set(ids.ravel().tolist()) & set(deleted):
            raise AssertionError(f"{name}: bad ids (pad or deleted id)")
        if not np.isfinite(d).all():
            raise AssertionError(f"{name}: non-finite distances")
    if recalls["ivf_pq"] < RECALL_FLOOR:
        raise AssertionError(f"ivf_pq: recall@{K} {recalls['ivf_pq']} < "
                             f"{RECALL_FLOOR}")
    if recalls["ivf_pq"] > recalls["ivf_flat"] + 0.005:
        raise AssertionError("ivf_pq: recall above the flat probe's")
    _, own = ivf.search_batch(fresh, N_PROBE, 1, pq=True, fetch=FETCH)
    if own[:, 0].tolist() != new_ids:
        raise AssertionError("ivf_pq: an added id is not its own top-1")
    log("ivf_pq: added ids found by self-query; no deleted id returned")
    ivf_rp_and_scans(torch, kernels, ivf, np.concatenate([x, fresh]),
                     queries, truth_slots, batches, deleted)

    # adc_probe at the main path's shape: one query block as search_batch
    # gathers it (B = 64 queries, P = n_probe * L candidates)
    cell_slots, cell_codes, cell_s = ivf._device_cells()
    qb = qd[:64]
    nb = qb.shape[0]
    cd, probe = _probe(qb, ivf._centroids_dev, N_PROBE)
    q_rot = ivf._pq.rotate_queries(queries[:nb])
    lut = _adc_lut(q_rot, ivf._pq.codebooks)
    slots = cell_slots[probe].reshape(nb, -1)
    codes = cell_codes[probe].reshape(nb, -1, PQ_M)
    corr = (cell_s[probe].reshape(nb, -1) + (
        torch.gather(cd, 1, probe) - (q_rot * q_rot).sum(-1)[:, None]
    ).repeat_interleave(cell_slots.shape[1], dim=1))
    ok = (slots >= 0) & ivf._has_emb[slots.clamp_min(0).long()]
    p_cand = slots.shape[1]
    e = check_topk("adc_probe main", adc_probe_scores(lut, codes, corr, ok),
                   None, adc_probe_plain(lut, codes, corr, ok), None,
                   group=p_cand, scale=adc_terms(lut, corr))
    kernels["adc_probe"]["max_abs_err"] = max(
        kernels["adc_probe"]["max_abs_err"], e)
    # its inputs (~29 MB) fit in the 50 MB L2: the line's times read them
    # from HBM, as the search does (each call gathers new candidates)
    ms = cuda_ms(torch, l2_cold(torch, adc_probe_scores, lut, codes, corr,
                                ok))
    plain_ms = cuda_ms(torch, l2_cold(torch, adc_probe_plain, lut, codes,
                                      corr, ok))
    warm_ms = cuda_ms(torch, lambda: adc_probe_scores(lut, codes, corr, ok))
    kernels["adc_probe"].update(ms=ms, plain_ms=plain_ms)
    # what any implementation moves: mask, corr and the scores in full,
    # the codes of the live candidates only, each query's LUT once
    live = int(ok.sum())
    set_bound(kernels["adc_probe"],
              nb * p_cand * (1 + 4 + 4) + live * PQ_M
              + nb * PQ_M * PQ_KSUB * 4,
              float(live) * (PQ_M + 1), F32_FLOPS)
    log(f"adc_probe B={nb} P={p_cand} (L={cell_slots.shape[1]}) m={PQ_M} "
        f"ksub={PQ_KSUB}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"max abs err {e}; live candidates {live} of {nb * p_cand} "
        f"({live / (nb * p_cand):.3f}); bound "
        f"{kernels['adc_probe']['bound_ms']:.4f} ms "
        f"({kernels['adc_probe']['bound_by']}), kernel at "
        f"{ms / kernels['adc_probe']['bound_ms']:.2f}x (inputs from HBM); "
        f"inputs in L2 (one set back to back) {warm_ms:.4f} ms; profiler "
        f"adc_probe_kernel {probe_row_ms} ms a launch in the ivf_pq profile")
    peak = torch.cuda.max_memory_allocated()
    del cell_slots, cell_codes, cell_s, lut, codes, corr, ok, slots

    # PQCodec over the corpus: the adc_topk scan against its gather mode
    t0 = time.perf_counter()
    codec = PQCodec(k=PQ_KSUB, chunks=PQ_M, dim=IVF_DIM, device="cuda")
    sample = np.random.default_rng(0).choice(IVF_N, min(IVF_N, 65536),
                                             replace=False)
    codec.train(x[sample], seed=0)
    codes = torch.from_numpy(codec.encode(x)).cuda()
    log(f"PQCodec trained on {sample.size} rows and encoded {IVF_N} in "
        f"{time.perf_counter() - t0:.1f} s")
    adc_topk.launches = 0
    got = codec.adc_search(queries[:ADC_B], codes, top_k=ADC_K)
    scan_launches = adc_topk.launches
    want = codec.adc_search(queries[:ADC_B], codes, top_k=ADC_K + 1,
                            mode="gather")
    e = check_topk("PQCodec.adc_search", *map(torch.from_numpy, got),
                   *map(torch.from_numpy, want), group=ADC_K)
    log(f"PQCodec.adc_search (default mode) agrees with mode='gather' at "
        f"N={IVF_N}, B={ADC_B}, k={ADC_K}: max abs err {e}; adc_topk "
        f"launches {scan_launches}")
    if scan_launches <= 0:
        raise AssertionError("adc_topk: no launch on the PQCodec path")
    kernels["adc_topk"]["launches"] += scan_launches
    kernels["adc_topk"]["max_abs_err"] = max(
        kernels["adc_topk"]["max_abs_err"], e)
    del codec, codes, ivf

    # FlatIndex at k = 300, past l2_topk's 256: two passes of the kernel
    sub = x[:131072]
    flat = FlatIndex(capacity=1 << 17, device="cuda")
    flat.insert_nodes([Node(id=i, embedding=sub[i])
                       for i in range(sub.shape[0])])
    launches = l2_topk.launches
    _, ids = flat.search_batch(queries[:8], 300)
    if l2_topk.launches != launches + 2 or ids.shape != (8, 300):
        raise AssertionError("FlatIndex k=300 did not take two passes of "
                             "l2_topk")
    float64_bound("FlatIndex k=300", sub, queries[:8], ids, 300)
    log("FlatIndex f32 at k=300 over 131072 rows (two l2_topk passes): "
        "within the float64 bound")
    log(f"IVF-PQ summary: build {build_s:.1f} s, enable_pq {pq_s:.1f} s, "
        f"QPS {qps}, recall@{K} {recalls}, peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")


def bench_rows(torch, rows, batches, queries, counters=(), warm=2):
    """The phases' bench method on each row (name -> (call, kwargs)): the
    answer on ``queries``, then ``warm`` warm-ups and timed calls on the
    rest of the perturbed ``batches`` (median of the host clock, each call
    ending in a sync). Each counter (a wrapper with ``launches``) is set to
    0 just before a row and read just after it. Returns ({row: answer},
    {row: QPS}, {row: {counter: launches}})."""
    results, qps, launches = {}, {}, {}
    for name, (call, kw) in rows.items():
        for c in counters:
            c.launches = 0
        results[name] = call(queries, **kw)
        secs = []
        for i, qb in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(qb, **kw)
            torch.cuda.synchronize()
            if i >= warm:
                secs.append(time.perf_counter() - t0)
        qps[name] = len(queries) / statistics.median(secs)
        launches[name] = {c.__name__: c.launches for c in counters}
        log(f"{name}: QPS {qps[name]:.1f} ({kw}; B={len(queries)}, median "
            f"of {len(secs)} host-clock reps); launches {launches[name]}")
    return results, qps, launches


def ivf_rp_and_scans(torch, kernels, ivf, xs, queries, truth_slots, batches,
                     deleted):
    """Phase 4, the residual projection and both full scans on the phase's
    index: enable_rp, RP at RP_PROBES and over every cell, the residual-PQ
    full scan (adc_topk with its row and group terms), each against the
    port's exact scan with its floor; the biased adc_topk against its
    plain version at the scan's own inputs, its time, bound and lookup
    floor; the l2_topk calls of the flat RP route (if the residual ratio
    picked it) against theirs; profiles of the full scans."""
    from vector_db_tpu_torch.index import ivf as ivf_module
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk, adc_topk_plain
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk

    t0 = time.perf_counter()
    ivf.enable_rp(dims=RP_DIMS)
    ivf._rebuild_device_tables()
    torch.cuda.synchronize()
    rp_s = time.perf_counter() - t0
    route = "flat" if ivf._rp_res_ratio > 0.5 else "cell-block scan"
    log(f"enable_rp(dims={RP_DIMS}) and the RP cell blocks: {rp_s:.1f} s; "
        f"residual ratio {ivf._rp_res_ratio:.4f}: the full RP scan takes "
        f"the {route} route")
    # coarse probe ceilings (scripts/bench_sift.py:140-156): the share of
    # true neighbours whose cell is among the query's n_probe nearest
    cell = ivf._slot_cell_table()[truth_slots]
    cents = ivf.centroids
    order = np.argsort((cents * cents).sum(-1)[None, :]
                       - 2.0 * (queries @ cents.T), axis=1)
    ceil = {p: float(np.mean([np.isin(c, o[:p]).mean()
                              for c, o in zip(cell, order)]))
            for p in RP_PROBES}
    log(f"probe ceilings (spill 1): {ceil}")
    def call(q, n_probe, **kw):
        return ivf.search_batch(q, n_probe, K, **kw)

    rows = {f"ivf_rp_{p}": (call, dict(n_probe=p, rp=True, fetch=RP_FETCH))
            for p in RP_PROBES}
    rows["ivf_rp_full"] = (call, dict(n_probe=IVF_CELLS, rp=True,
                                      fetch=RP_FULL_FETCH))
    rows["ivf_pq_full"] = (call, dict(n_probe=IVF_CELLS, pq=True,
                                      fetch=PQ_SCAN_FETCH))
    results, qps, launches = bench_rows(torch, rows, batches, queries,
                                        (adc_topk, l2_topk))
    truth = ivf._store.ids_of(truth_slots)
    recalls = {name: recall_at(r[1], truth) for name, r in results.items()}
    log(f"recall@{K} against the port's exact scan: {recalls}")
    for name, (d, ids) in results.items():
        if ids.shape != (B, K) or (ids < 0).any() or \
                set(ids.ravel().tolist()) & set(deleted):
            raise AssertionError(f"{name}: bad ids (pad or deleted id)")
        # the IVF rerank is the expanded f32 form (the JAX package's
        # gather_l2_sq): its error is relative to ||q||^2 + ||x||^2
        rows_x = xs[ids[:8]].astype(np.float64)
        q64 = queries[:8, None, :].astype(np.float64)
        d64 = ((rows_x - q64) ** 2).sum(-1)
        tol = RTOL * ((rows_x ** 2).sum(-1) + (q64 ** 2).sum(-1)) + ATOL
        if (np.abs(d[:8].astype(np.float64) ** 2 - d64) > tol).any() or \
                (np.diff(d, axis=1) < 0).any():
            raise AssertionError(f"{name}: a distance is not the exact L2 "
                                 "within the f32 expansion's error, or "
                                 "not ascending")
    floors = {f"ivf_rp_{p}": ceil[p] - RP_CEIL_SLACK for p in RP_PROBES}
    floors.update(ivf_rp_full=RP_FULL_FLOOR, ivf_pq_full=PQ_SCAN_FLOOR)
    for name, floor in floors.items():
        if recalls[name] < floor:
            raise AssertionError(f"{name}: recall@{K} {recalls[name]} < "
                                 f"{floor}")
    pq_launches = launches["ivf_pq_full"]["adc_topk"]
    if pq_launches != 1 + len(batches):
        raise AssertionError(f"ivf_pq_full: adc_topk launched {pq_launches}"
                             f" times over {1 + len(batches)} calls")
    kernels["adc_topk"]["launches"] = pq_launches
    flat_l2 = launches["ivf_rp_full"]["l2_topk"]
    if route == "flat" and flat_l2 != 1 + len(batches):
        raise AssertionError(f"ivf_rp_full: l2_topk launched {flat_l2} "
                             "times on the flat route")
    kernels["l2_topk_bf16"]["launches"] += flat_l2
    log(f"floors held: {floors}; distances the exact L2 on 8 queries (within"
        f" the f32 expansion's error), ascending; launches on "
        f"the full scans: adc_topk {pq_launches} (one a call), l2_topk "
        f"bf16 {flat_l2} (the RP {route})")
    if route == "flat":
        err = check_l2_calls(torch, log, "ivf_rp_full flat route",
                             lambda: call(queries, **rows["ivf_rp_full"][1]),
                             torch.bfloat16)
        fold_err(kernels, "l2_topk_bf16", err)

    # the biased adc_topk at the PQ scan's own inputs
    (args, opts), = captured(ivf_module, "adc_topk", lambda: call(
        queries, **rows["ivf_pq_full"][1]))
    lut, codes, valid, k = args
    n_rows, live = codes.shape[0], int(valid.sum())
    sub = dict(opts, group_bias=opts["group_bias"][:ADC_CHECK_B])
    lut_s = lut[:ADC_CHECK_B]
    terms = (lut_s.amax(-1).sum(-1) + opts["row_bias"].abs().max()
             + sub["group_bias"].abs().amax(-1)).cpu().numpy()
    e = check_topk("adc_topk biased (PQ scan inputs)",
                   *adc_topk(lut_s, codes, valid, k, **sub),
                   *adc_topk_plain(lut_s, codes, valid, k + 1, **sub),
                   group=k, scale=terms)
    fold_err(kernels, "adc_topk", e)
    ms = cuda_ms(torch, lambda: adc_topk(lut, codes, valid, k, **opts))
    sub_ms = cuda_ms(torch, lambda: adc_topk(lut_s, codes, valid, k, **sub))
    sub_plain_ms = cuda_ms(torch, lambda: adc_topk_plain(
        lut_s, codes, valid, k, **sub), reps=1)
    b, m, ksub = lut.shape
    groups = opts["group_bias"].shape[1]
    nbytes = (live * m + n_rows + n_rows * 4 + b * groups * 4
              + b * m * ksub * 4 + b * k * 8)
    bnd_ms, bnd_by = bound(nbytes, float(b) * live * (m + 2), F32_FLOPS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor_ms = float(b) * n_rows * m / (32.0 * sms * BOOST_MHZ * 1e6) * 1e3
    log(f"adc_topk with row and group terms at the PQ scan's shape (B={b}, "
        f"N={n_rows} padded slots of {groups} cells, {live} live, m={m}, "
        f"ksub={ksub}, k={k}): kernel {ms:.3f} ms a call, {pq_launches} "
        f"launches; bound {bnd_ms:.4f} ms ({bnd_by}: the live rows' codes, "
        f"the mask, terms and LUTs once, one add a live (query, row, "
        f"subspace)); lookup floor {floor_ms:.4f} ms ({b * n_rows * m:.3g} "
        f"lookups: the kernel looks up padded slots too), kernel at "
        f"{ms / floor_ms:.2f}x the floor; on {ADC_CHECK_B} queries kernel "
        f"{sub_ms:.3f} ms, plain {sub_plain_ms:.1f} ms, max abs err {e}")
    pq_rows = profile(torch, "ivf_pq_full", lambda: call(
        batches[0], **rows["ivf_pq_full"][1]))
    profile(torch, "ivf_rp_full", lambda: call(batches[0],
                                               **rows["ivf_rp_full"][1]))
    log(f"IVF RP / full-scan summary: enable_rp {rp_s:.1f} s, QPS {qps}, "
        f"recall@{K} {recalls}, profiler adc_scan_kernel "
        f"{kernel_row_ms(pq_rows, 'adc_scan_kernel')} ms a launch")


def profile(torch, label, fn, reps: int = 3):
    """Device busy time of ``reps`` calls of ``fn`` under torch.profiler
    (the sum of the CUDA rows of key_averages), its idle share of the wall
    time, and the largest device items. Returns the CUDA rows."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    t_all = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    with profiler(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r.self_device_time_total for r in rows) / reps / 1e6
    if busy <= 0:
        log(f"{label} profile: no device time in the trace (not measured)")
        return rows
    top = sorted(rows, key=lambda r: -r.self_device_time_total)[:6]
    log(f"{label} profile ({time.perf_counter() - t_all:.1f} s with the "
        f"warm-up and the profiler's processing): wall "
        f"{wall * 1e3:.1f} ms/call, device busy "
        f"{busy * 1e3:.1f} ms/call, idle share {1 - busy / wall:.3f}; "
        "largest: " + "; ".join(
            f"{r.key[:48]} {r.self_device_time_total / reps / 1e3:.2f} ms "
            f"({r.count // reps}x)" for r in top))
    return rows


def kernel_row_ms(rows, name):
    """Device ms a launch of the kernel whose profiler row names ``name``
    (None where the trace has no such row)."""
    hits = [r for r in rows if name in r.key]
    if not hits:
        return None
    return (sum(r.self_device_time_total for r in hits) / 1e3
            / sum(r.count for r in hits))


def exact_distances(name, x, queries, dists, ids) -> None:
    """Reported distances ascending and each within float64 of the true L2
    distance of its id (the exact rerank's contract)."""
    live = ids >= 0
    d64 = np.sqrt(((x[np.maximum(ids, 0)].astype(np.float64)
                    - queries[:, None, :].astype(np.float64)) ** 2).sum(-1))
    if not (np.abs(dists - d64) <= 1e-5 * d64 + 1e-6)[live].all():
        raise AssertionError(f"{name}: a distance is not the exact L2")
    if (np.diff(np.where(live, dists, np.inf), axis=1) < 0).any():
        raise AssertionError(f"{name}: distances not ascending")


def hnsw_inserts(torch, idx, x, n_build):
    """Stream rows n_build.. of x into ``idx`` through insert_arrays, a
    batch of INSERT_BATCH a call, the last 4 under the profiler. l2_topk
    must launch 1 + (the entry level before the batch) times a batch: the
    level-0 scan and one per upper level. Returns (inserts/s over the
    timed batches after the first, the first batch's s, peak bytes, the
    candidate scan's max abs err against the plain version)."""
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk

    scan_err = insert_scan_check(torch, idx, x[n_build:n_build + INSERT_BATCH])
    batches = iter(range(n_build, HNSW_N, INSERT_BATCH))
    n_batches = math.ceil((HNSW_N - n_build) / INSERT_BATCH)
    expected = [0]

    def insert_next():
        s = next(batches)
        e = min(s + INSERT_BATCH, HNSW_N)
        expected[0] += 1 + idx.graph.entry_level
        idx.insert_arrays(range(s, e), x[s:e], batch_size=INSERT_BATCH)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # the insert path: counts at 0 just before it
    l2_topk.launches = 0
    l2_topk.launches_bf16 = 0
    secs = []
    for _ in range(n_batches - 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        insert_next()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    profile(torch, "HNSW insert batch", insert_next)   # the last 4 batches
    torch.cuda.synchronize()
    launches, bf16 = l2_topk.launches, l2_topk.launches_bf16
    peak = torch.cuda.max_memory_allocated()
    if next(batches, None) is not None or idx.size != HNSW_N:
        raise AssertionError(f"inserts: {idx.size} rows, not {HNSW_N}")
    if launches != expected[0] or bf16:
        raise AssertionError(f"inserts: l2_topk launched {launches} times "
                             f"({bf16} bf16), expected {expected[0]}")
    rate = INSERT_BATCH * (len(secs) - 1) / sum(secs[1:])
    log(f"streamed {HNSW_N - n_build} rows in {n_batches} insert_arrays "
        f"calls of {INSERT_BATCH} (exact candidates, grouped commit): "
        f"{rate:.1f} inserts/s over batches 2-{len(secs)} (host clock, "
        f"synced; per batch {[round(t * 1e3, 1) for t in secs]} ms), first "
        f"batch {secs[0] * 1e3:.1f} ms; l2_topk launches {launches} "
        f"(expected {expected[0]}: 1 + the entry level a batch); peak "
        f"device memory {peak} bytes, {peak - base} above the index's "
        f"{base}")
    return rate, secs[0], peak - base, scan_err


def insert_scan_check(torch, idx, batch, say=log) -> float:
    """The insert candidate scan's l2_topk calls, at the inputs the first
    insert batch gives them, held against l2_topk_plain: level 0 over the
    whole f32 table at k = ef_construction under the level mask, and level
    1 over its gathered rows at k = min(64, ef_construction). Returns the
    max abs err."""
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk, l2_topk_plain
    from vector_db_tpu_torch.ops.distance import squared_norms

    emb, has_emb, levels = idx._emb, idx._has_emb, idx.graph.levels
    q = torch.from_numpy(np.ascontiguousarray(batch)).to(emb.device)
    x_sq = squared_norms(emb)
    up = torch.nonzero(levels >= 1).flatten()
    cases = [("level 0", emb, has_emb & (levels >= 0), x_sq, HNSW_EFC),
             ("level 1", emb[up], has_emb[up], x_sq[up],
              min(64, HNSW_EFC, up.numel()))]
    err = 0.0
    for label, tab, valid, sq, k in cases:
        got = l2_topk(q, tab, valid, k, x_sq=sq)
        want = l2_topk_plain(q, tab, valid, k + 1, sq)
        name = (f"insert scan {label}: l2_topk f32 n={tab.shape[0]} "
                f"d={tab.shape[1]} b={q.shape[0]} k={k}")
        e = check_topk(name, *got, *want, group=k,
                       scale=((q * q).sum(-1) + sq.max()).cpu().numpy())
        say(f"{name} against l2_topk_plain: max abs err {e}")
        err = max(err, e)
    return err


def check_inserted(torch, idx, x, n_build, n_end=None, sample=None,
                   say=log):
    """The streamed rows (ids n_build..n_end, by default to HNSW_N) are in
    the graph: each has a level-0 out-edge, >= 99 % an in-edge; no row has
    a self-edge or a repeated edge; the levels mirror is the device's; the
    rows of ``sample`` (by default the first SELF_CHECK) are their own
    top-1 under the classic beam on >= 99 %. The graph's M and depth are
    the index's own."""
    from vector_db_tpu_torch.index import hnsw_kernels as HK

    n_end = HNSW_N if n_end is None else n_end
    if sample is None:
        sample = np.arange(n_build, n_build + SELF_CHECK)
    g = idx.graph
    nb = g.neighbors
    m2 = 2 * idx.M
    slots = torch.tensor([idx._slot_of_id[i] for i in range(n_build, n_end)],
                         device=nb.device)
    out_deg = (nb[slots, :m2] >= 0).sum(1)
    if int((out_deg < 1).sum()):
        raise AssertionError(f"{int((out_deg < 1).sum())} inserted rows "
                             "have no level-0 edge")
    lvl0 = nb[:, :m2]
    has_in = torch.zeros(nb.shape[0], dtype=torch.bool, device=nb.device)
    has_in[lvl0[lvl0 >= 0].long()] = True
    no_in = int((~has_in[slots]).sum())
    if no_in > 0.01 * slots.numel():
        raise AssertionError(f"{no_in} inserted rows have no in-edge")
    own = torch.arange(nb.shape[0], device=nb.device, dtype=nb.dtype)
    if bool((nb == own[:, None]).any()):
        raise AssertionError("a row has an edge to itself")
    for level in range(idx.l_max):
        start = HK.level_col_start(level, idx.M)
        srt = nb[:, start:start + HK.level_width(level, idx.M)].sort(1).values
        rep = int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
        if rep:
            raise AssertionError(f"{rep} repeated edges at level {level}")
    if not np.array_equal(g.levels.cpu().numpy(), idx._levels_host):
        raise AssertionError("levels mirror differs from the device levels")
    _, ids = idx.search_batch(x[sample], 1, ef=CLASSIC_EF)
    own_top1 = float(np.mean(ids[:, 0] == sample))
    if own_top1 < 0.99:
        raise AssertionError(f"inserted rows: own top-1 on {own_top1}")
    say(f"inserted rows: all with a level-0 out-edge, {no_in} of "
        f"{slots.numel()} without an in-edge; no self or repeated edge in "
        f"the table; levels mirror equal; own top-1 (classic, ef "
        f"{CLASSIC_EF}) on {own_top1:.4f} of {len(sample)} (ids "
        f"{int(sample[0])}..{int(sample[-1])})")
    return no_in, own_top1


def hnsw_persist(torch, idx, x, queries):
    """save_index to a temporary directory, then a reload into a new
    HNSW(device="cuda") over MMapNodeStorage holding the live rows (filled
    by one save_many call): the tables and the id map bit-equal, nothing
    to re-link, the same ids on the B queries (classic). Returns (npz
    bytes, save s, storage fill s, load s)."""
    import tempfile
    from pathlib import Path

    from vector_db_tpu_torch import HNSW, Node
    from vector_db_tpu_torch.storage import MMapNodeStorage

    with tempfile.TemporaryDirectory() as tmp:
        idx.index_file = Path(tmp) / "hnsw.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.save_index()
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(idx.index_file)
        id_map = idx._store.export_id_map()
        live = np.sort(id_map[id_map >= 0])
        t0 = time.perf_counter()
        storage = MMapNodeStorage(Path(tmp) / "emb.npy",
                                  Path(tmp) / "meta.npy", dim=HNSW_DIM,
                                  capacity=HNSW_N, content_chars=16,
                                  metadata_chars=16)
        storage.save_many([Node(id=int(i), embedding=x[i]) for i in live])
        if storage.size() != live.size:
            raise AssertionError(f"filled storage: {storage.size()} rows, "
                                 f"not {live.size}")
        fill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = HNSW(M=4, ef_construction=10, rng=random.Random(0),
                     storage=storage, index_file=idx.index_file,
                     device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        a, b = again.graph, idx.graph
        if not (torch.equal(a.neighbors, b.neighbors)
                and torch.equal(a.levels, b.levels)
                and (a.entry, a.entry_level) == (b.entry, b.entry_level)
                and np.array_equal(again._id_of_slot, id_map)
                and np.array_equal(again._levels_host, idx._levels_host)):
            raise AssertionError("reload: tables differ from the saved ones")
        if again.size != idx.size or again.recover_unlinked():
            raise AssertionError("reload: rows to re-link after a clean save")
        want = idx.search_batch(queries, K, ef=CLASSIC_EF)[1]
        got = again.search_batch(queries, K, ef=CLASSIC_EF)[1]
        if not np.array_equal(got, want):
            raise AssertionError(f"reload: {int((got != want).sum())} ids "
                                 "differ on the queries")
        # the trained PQ and RP state came back with it (codes re-encoded)
        qp = queries[:PERSIST_Q]
        for mode in ("pq", "rp"):
            call = f"search_batch_{mode}"
            want = getattr(idx, call)(qp, K, ef=CLASSIC_EF, expand=4)[1]
            got = getattr(again, call)(qp, K, ef=CLASSIC_EF, expand=4)[1]
            if not np.array_equal(got, want):
                raise AssertionError(f"reload: {call} ids differ on "
                                     f"{int((got != want).any(1).sum())} "
                                     "queries")
        storage.close()
        del again
    idx.index_file = None
    log(f"persistence: save_index {save_s:.2f} s ({nbytes} bytes of npz); "
        f"MMapNodeStorage over {live.size} rows (one save_many) in "
        f"{fill_s:.1f} s; load "
        f"(HNSW(index_file=...): "
        f"npz, hydration from storage, recover_unlinked) {load_s:.2f} s; "
        f"tables, id map and levels bit-equal; classic ids equal on {B} "
        f"queries, search_batch_pq and search_batch_rp ids on {PERSIST_Q} "
        "(the codebooks, OPQ rotation and projection reloaded)")
    return nbytes, save_s, fill_s, load_s


def hnsw_modes(torch, kernels, idx, x, queries, truth, batches, deleted):
    """Phase 5's PQ and RP traversals, the PQ-scored wide beam, and the
    inline tables with the pool-free beam and the inline wide beam, each
    against the port's exact scan with its floor, distances exact on 8
    queries; sorted_topk launches counted per row, and the kernel held
    against its plain version on the PQ-scored merge's own input. Returns
    the summary."""
    from vector_db_tpu_torch.index import wide_beam
    from vector_db_tpu_torch.ops.cuda.sorted_topk import (
        sorted_topk, sorted_topk_plain)

    times = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx.enable_rp(dims=RP_DIMS)
    idx._rp_tables()
    torch.cuda.synchronize()
    times["enable_rp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.enable_pq(chunks=PQ_M, ksub=PQ_KSUB, opq_iters=HNSW_OPQ_ITERS)
    torch.cuda.synchronize()
    times["enable_pq"] = time.perf_counter() - t0
    log(f"enable_rp(dims={RP_DIMS}) and its mirror {times['enable_rp']:.1f}"
        f" s; enable_pq(chunks={PQ_M}, ksub={PQ_KSUB}, opq_iters="
        f"{HNSW_OPQ_ITERS}) {times['enable_pq']:.1f} s")
    wide = dict(k=K, dedup_window=16, seen_mask=False, merge_kernel=True)
    rows = {f"rp_{ef}": (idx.search_batch_rp, dict(k=K, ef=ef, expand=4))
            for ef in HNSW_RP_EFS}
    rows[f"pq_{HNSW_PQ_EF}"] = (idx.search_batch_pq,
                                dict(k=K, ef=HNSW_PQ_EF, expand=4))
    # classic PQ / RP: phase 10 times them at these settings
    # (scripts/bench_1m_torch.py's hnsw_rp and hnsw_opq rows); one timed
    # call each here
    res, qps, launches = bench_rows(torch, rows, batches[:1], queries,
                                    (sorted_topk,), warm=0)
    floors = {f"rp_{ef}": f for ef, f in HNSW_RP_EFS.items()}
    floors[f"pq_{HNSW_PQ_EF}"] = HNSW_PQ_FLOOR
    rows = {"wide_pq": (idx.search_batch_wide,
                        dict(k=K, score="pq", merge_kernel=True, **WIDE_PQ))}
    r2, q2, l2 = bench_rows(torch, rows, batches, queries, (sorted_topk,))
    # sorted_topk on the PQ-scored merge's own input (a wider pool than
    # the exact route's, keys from the PQ-decoded mirror); these launches
    # only compare, and count nowhere
    seen = captured(wide_beam, "sorted_topk", lambda: idx.search_batch_wide(
        queries, k=K, score="pq", merge_kernel=True, **WIDE_PQ))
    (d, v, topk), kw = seen[WIDE_PQ["steps"] // 2]
    e = check_sorted("sorted_topk wide_pq", sorted_topk(d, v, topk, **kw),
                     sorted_topk_plain(d, v, min(topk + 1, d.shape[1])))
    fold_err(kernels, "sorted_topk", e)
    log(f"sorted_topk {d.dtype} keys [{d.shape[0]}, {d.shape[1]}] -> topk="
        f"{topk} {kw} (wide_pq's merge input of step {WIDE_PQ['steps'] // 2}"
        f"): keys equal the plain version's, payloads equal within runs of "
        f"equal keys, max abs err {e}")
    t0 = time.perf_counter()
    idx.enable_wide(dims=INLINE_DIMS, seeds=WIDE_SEEDS, inline=True)
    idx._wide_tables()
    torch.cuda.synchronize()
    times["enable_wide_inline"] = time.perf_counter() - t0
    tabs = idx._wb[3]
    inline_bytes = sum(a.numel() * a.element_size() for a in tabs)
    log(f"enable_wide(dims={INLINE_DIMS}, seeds={WIDE_SEEDS}, inline=True) "
        f"with its tables: {times['enable_wide_inline']:.1f} s; inline "
        f"tables {inline_bytes} bytes ({inline_bytes / 2**30:.2f} GiB)")
    # the beam rows: phase 10 times them at these settings
    # (scripts/bench_1m_torch.py's hnsw_beam rows); one timed call each
    rows = {f"beam_{f}": (idx.search_batch_beam,
                          dict(k=K, frontier=f, steps=BEAM_T,
                               hist=BEAM_HIST)) for f in BEAM_FLOORS}
    r4, q4, l4 = bench_rows(torch, rows, batches[:1], queries,
                            (sorted_topk,), warm=0)
    rows = {"wide_inline": (idx.search_batch_wide,
                            dict(wide, ef=WIDE_EF, frontier=WIDE_F,
                                 steps=WIDE_T))}
    r3, q3, l3 = bench_rows(torch, rows, batches, queries, (sorted_topk,))
    for got, more in ((res, (r2, r3, r4)), (qps, (q2, q3, q4)),
                      (launches, (l2, l3, l4))):
        for m in more:
            got.update(m)
    floors.update(wide_pq=WIDE_PQ_FLOOR, wide_inline=WIDE_FLOOR,
                  **{f"beam_{f}": v for f, v in BEAM_FLOORS.items()})
    peak = torch.cuda.max_memory_allocated()
    recalls = {name: recall_at(r[1], truth) for name, r in res.items()}
    log(f"recall@{K} against the port's exact scan: {recalls}; floors "
        f"{floors}; peak device memory of these modes {peak} bytes "
        f"({peak / 2**30:.2f} GiB, the inline tables included)")
    for name, (d, ids) in res.items():
        if ids.shape != (B, K) or (ids < 0).any() or \
                set(ids.ravel().tolist()) & set(deleted):
            raise AssertionError(f"{name}: bad ids (pad or deleted id)")
        exact_distances(name, x, queries[:8], d[:8], ids[:8])
        if recalls[name] < floors[name]:
            raise AssertionError(f"{name}: recall@{K} {recalls[name]} < "
                                 f"{floors[name]}")
    calls = 1 + len(batches)
    for name in ("wide_pq", "wide_inline"):
        if launches[name]["sorted_topk"] != WIDE_T * calls:
            raise AssertionError(f"{name}: sorted_topk launched "
                                 f"{launches[name]['sorted_topk']} times, "
                                 f"not {WIDE_T} a call")
    if any(launches[n]["sorted_topk"] for n in launches
           if not n.startswith("wide")):
        raise AssertionError("sorted_topk launched outside the wide rows")
    kernels["sorted_topk"]["launches"] += (launches["wide_pq"]["sorted_topk"]
                                           + launches["wide_inline"][
                                               "sorted_topk"])
    log("floors held; distances exact and ascending on 8 queries a row; "
        f"sorted_topk {WIDE_T} launches a call on the wide rows, none on "
        "the classic and beam rows")
    for name, call, kw in (
            ("beam_224", idx.search_batch_beam,
             dict(k=K, frontier=224, steps=BEAM_T, hist=BEAM_HIST)),
            ("wide_pq", idx.search_batch_wide,
             dict(k=K, score="pq", merge_kernel=True, **WIDE_PQ)),
            (f"pq_{HNSW_PQ_EF}", idx.search_batch_pq,
             dict(k=K, ef=HNSW_PQ_EF, expand=4))):
        profile(torch, name, lambda: call(batches[0], **kw), reps=1)
    return {"seconds": times, "qps": qps, "recall": recalls,
            "peak": peak, "inline_bytes": inline_bytes}


def phase_hnsw(torch, kernels):
    """Phase 5: HNSW at 1M x 768: bulk build, streaming inserts, delete,
    wide and classic search, sorted_topk on the main path's own merge
    input, and a save and reload."""
    from vector_db_tpu_torch import HNSW, embedding_like
    from vector_db_tpu_torch.index import wide_beam
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk
    from vector_db_tpu_torch.ops.cuda.sorted_topk import (
        sorted_topk, sorted_topk_plain)
    from vector_db_tpu_torch.ops.exact import exact_search_tiled

    t0 = time.perf_counter()
    x = embedding_like(HNSW_N + B, HNSW_DIM, seed=0, device="numpy")
    queries = np.ascontiguousarray(x[HNSW_N:])
    x = x[:HNSW_N]
    _SHARED["emb768"] = (x, queries)    # scripts/bench_1m.py's corpus
    log(f"corpus {HNSW_N} x {HNSW_DIM} and {B} queries made "
        f"({time.perf_counter() - t0:.1f} s, host)")
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts at 0 just before the build
    n_build = HNSW_N - HNSW_INSERT
    l2_topk.launches = 0
    l2_topk.launches_bf16 = 0
    sorted_topk.launches = 0
    t0 = time.perf_counter()
    idx = HNSW(M=HNSW_M, ef_construction=HNSW_EFC, rng=random.Random(42),
               capacity=HNSW_N, l_max=HNSW_LMAX, device="cuda")
    idx.bulk_build(range(n_build), x[:n_build], alpha=1.0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_l2 = l2_topk.launches
    lv = idx._levels_host
    per_level = [int((lv >= level).sum()) for level in range(HNSW_LMAX)]
    log(f"HNSW(M={HNSW_M}, l_max={HNSW_LMAX}).bulk_build of {n_build} rows: "
        f"{build_s:.1f} s; nodes per level {per_level}; l2_topk launches in "
        f"the build (knn_exact) {build_l2}")
    if build_l2 <= 0:
        raise AssertionError("bulk_build: no l2_topk launch under knn_exact")
    insert_rate, first_batch_s, insert_mem, scan_err = hnsw_inserts(
        torch, idx, x, n_build)
    kernels["l2_topk"]["max_abs_err"] = max(
        kernels["l2_topk"]["max_abs_err"], scan_err)
    lv = idx._levels_host
    log("nodes per level after the inserts "
        f"{[int((lv >= level).sum()) for level in range(HNSW_LMAX)]}")
    no_in, own_top1 = check_inserted(torch, idx, x, n_build)
    torch.cuda.reset_peak_memory_stats()

    qd = torch.from_numpy(queries).cuda()
    _, top1 = exact_search_tiled(qd[:N_DELETE], idx._emb, idx._has_emb, 1)
    deleted = sorted(set(idx._store.ids_of(top1.cpu().numpy())[:, 0]
                         .tolist()))
    for i in deleted:
        idx.delete_node(i)
    t0 = time.perf_counter()
    idx.enable_wide(dims=WIDE_DIMS, seeds=WIDE_SEEDS)
    idx._wide_tables()
    torch.cuda.synchronize()
    log(f"deleted {len(deleted)} ids (the exact top-1 of {N_DELETE} "
        f"queries); enable_wide(dims={WIDE_DIMS}, seeds={WIDE_SEEDS}) and "
        f"the mirror: {time.perf_counter() - t0:.1f} s")
    _, truth = exact_search_tiled(qd, idx._emb, idx._has_emb, K)
    truth = idx._store.ids_of(truth.cpu().numpy())

    wide = dict(k=K, ef=WIDE_EF, frontier=WIDE_F, steps=WIDE_T,
                dedup_window=16, seen_mask=False)
    modes = {"wide_merge_kernel": dict(wide, merge_kernel=True),
             "wide": dict(wide, merge_kernel=False),
             "classic": dict(k=K, ef=CLASSIC_EF)}
    rng = np.random.default_rng(5)
    batches = [queries + 0.01 * rng.standard_normal(queries.shape).astype(
        np.float32) for _ in range(5)]
    results, qps, launched = bench_rows(
        torch, {name: (idx.search_batch if name == "classic"
                       else idx.search_batch_wide, kw)
                for name, kw in modes.items()},
        batches, queries, (sorted_topk,))
    launches = {name: c["sorted_topk"] for name, c in launched.items()}
    calls = 1 + len(batches)
    log(f"sorted_topk launches per mode: {launches} over {calls} calls each")
    sorted_row_ms = None
    for name, kw in modes.items():
        call = idx.search_batch if name == "classic" else idx.search_batch_wide
        # one call each: the profiler's processing of the classic call's
        # ~6,000 small ops takes ~25 s a call
        rows = profile(torch, name, lambda: call(batches[0], **kw), reps=1)
        if name == "wide_merge_kernel":
            sorted_row_ms = kernel_row_ms(rows, "sorted_topk_kernel")
    if launches["wide_merge_kernel"] != WIDE_T * calls or \
            launches["wide"] or launches["classic"]:
        raise AssertionError(f"sorted_topk: expected {WIDE_T} launches per "
                             "merge_kernel=True call and none elsewhere")
    kernels["sorted_topk"]["launches"] = launches["wide_merge_kernel"]
    peak = torch.cuda.max_memory_allocated()

    recalls = {name: recall_at(r[1], truth) for name, r in results.items()}
    log(f"recall@{K} against the port's exact scan: {recalls}; on queries "
        f"{N_DELETE}-{B - 1} (the deletes were the others' nearest rows): "
        + str({name: round(recall_at(r[1][N_DELETE:], truth[N_DELETE:]), 4)
               for name, r in results.items()}))
    for name, (d, ids) in results.items():
        if ids.shape != (B, K) or (ids < 0).any() or \
                set(ids.ravel().tolist()) & set(deleted):
            raise AssertionError(f"{name}: bad ids (pad or deleted id)")
        exact_distances(name, x, queries[:8], d[:8], ids[:8])
    if recalls["wide_merge_kernel"] < WIDE_FLOOR:
        raise AssertionError(f"wide: recall@{K} {recalls['wide_merge_kernel']}"
                             f" < {WIDE_FLOOR}")
    if recalls["classic"] < CLASSIC_FLOOR:
        raise AssertionError(f"classic: recall@{K} {recalls['classic']} < "
                             f"{CLASSIC_FLOOR}")
    same = np.mean([set(a) == set(b) for a, b in zip(
        results["wide_merge_kernel"][1].tolist(),
        results["wide"][1].tolist())])
    if same < 0.99 or abs(recalls["wide_merge_kernel"]
                          - recalls["wide"]) > 0.002:
        raise AssertionError(f"merge_kernel=True/False: same id sets on "
                             f"{same} of queries")
    log(f"merge_kernel True/False: same id sets on {same:.4f} of queries; "
        "no deleted id returned; distances exact and ascending on 8 queries")

    # filtered wide search at 10 % selectivity
    allowed = set(range(0, HNSW_N, FILTER_EVERY))
    _, fids = idx.search_batch_wide(queries, filter_ids=allowed,
                                    **modes["wide_merge_kernel"])
    if not set(fids[fids >= 0].tolist()) <= allowed or \
            set(fids.ravel().tolist()) & set(deleted):
        raise AssertionError("wide: filtered search left the filter")
    mask = torch.from_numpy(idx._store.filter_mask(allowed)).cuda()
    _, ftruth = exact_search_tiled(qd, idx._emb, idx._has_emb & mask, K)
    frec = recall_at(fids, idx._store.ids_of(ftruth.cpu().numpy()))
    log(f"filtered wide search (1 in {FILTER_EVERY}): results inside the "
        f"filter; recall@{K} {frec:.4f} against the filtered exact scan")

    # sorted_topk on the main path's own merge input
    seen = []
    real = wide_beam.sorted_topk

    def record(d, v, topk, presorted=0):
        seen.append((d, v, topk))
        return real(d, v, topk, presorted=presorted)

    wide_beam.sorted_topk = record
    try:
        idx.search_batch_wide(queries, **modes["wide_merge_kernel"])
    finally:
        wide_beam.sorted_topk = real
    d, v, topk = seen[WIDE_T // 2]
    e = check_sorted("sorted_topk main", sorted_topk(d, v, topk),
                     sorted_topk_plain(d, v, topk + 1))
    kernels["sorted_topk"]["max_abs_err"] = max(
        kernels["sorted_topk"]["max_abs_err"], e)
    ms = cuda_ms(torch, lambda: sorted_topk(d, v, topk))
    plain_ms = cuda_ms(torch, lambda: sorted_topk_plain(d, v, topk))

    def library():
        top = torch.topk(d.float(), topk, dim=1, largest=False, sorted=True)
        return top.values, torch.gather(v, 1, top.indices)

    library_ms = cuda_ms(torch, library)
    kernels["sorted_topk"].update(ms=ms, plain_ms=plain_ms)
    per = d.element_size() + v.element_size()
    set_bound(kernels["sorted_topk"], d.shape[0] * (d.shape[1] + topk) * per,
              0.0, F32_FLOPS, library_ms=library_ms)
    log(f"sorted_topk {d.dtype} keys [{d.shape[0]}, {d.shape[1]}] -> "
        f"topk={topk} (the merge input of step {WIDE_T // 2}): kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, torch.topk + gather "
        f"{library_ms:.3f} ms, bound {kernels['sorted_topk']['bound_ms']:.4f}"
        f" ms; keys equal, payloads equal within runs of equal keys; "
        f"profiler sorted_topk_kernel {sorted_row_ms} ms a launch in the "
        f"wide_merge_kernel profile (all steps' shapes)")
    more = hnsw_modes(torch, kernels, idx, x, queries, truth, batches,
                      deleted)
    nbytes, save_s, fill_s, load_s = hnsw_persist(torch, idx, x, queries)
    log(f"HNSW summary: build {build_s:.1f} s ({n_build} rows), inserts "
        f"{insert_rate:.1f}/s (first batch {first_batch_s * 1e3:.1f} ms, "
        f"{insert_mem} bytes above the index; candidate scan max abs err "
        f"{scan_err}), {no_in} inserted rows "
        f"without an in-edge, own top-1 {own_top1:.4f}, QPS {qps}, recall@{K} "
        f"{recalls}, filtered recall {frec:.4f}, peak device memory of the "
        f"searches {peak} bytes ({peak / 2**30:.2f} GiB); save {save_s:.2f} s "
        f"({nbytes} bytes), storage fill {fill_s:.1f} s, load {load_s:.2f} s;"
        f" PQ / RP / beam modes {more}")


def svc_config(path, file_path, capacity=None, **index) -> str:
    """Write the phase's config: config.yaml's deployment (fake-384 in place
    of MiniLM-L6, whose weights the repo does not hold) on the card;
    ``capacity`` (default SVC_N) is vector_db.capacity."""
    import yaml

    cfg = {"embedding": {"model": f"fake-{SVC_DIM}", "dimension": SVC_DIM},
           "device": "cuda",
           "index": {"ef_construction": HNSW_EFC, "M": HNSW_M,
                     "flush_threshold": 1000, **index},
           "vector_db": {"file_path": str(file_path), "dimension": SVC_DIM,
                         "capacity": capacity or SVC_N}}
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def svc_hnsw(**extra) -> dict:
    """The HNSW service's index config (config.yaml's, with the scan
    route, the filtered scan and the wide beam on)."""
    return dict(type="hnsw", scan_batch_threshold=SVC_SCAN_THRESHOLD,
                filtered_engine="scan",
                wide={"enabled": True, "dims": 120, "seeds": 4096,
                      "min_size": SVC_MIN_SIZE, "merge_kernel": "auto"},
                **extra)


def median_qps(torch, call, batches) -> float:
    """Queries/s of ``call`` on the last 3 of ``batches`` (2 warm-ups),
    median of the host-clock reps, each ending in a device sync."""
    secs = []
    for i, qb in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(qb)
        torch.cuda.synchronize()
        if i >= 2:
            secs.append(time.perf_counter() - t0)
    return len(batches[0]) / statistics.median(secs)


def same_answer(name, got, want) -> None:
    """A service answer equals the direct index call's: ids and
    distances."""
    if not (np.array_equal(got[1], want[1])
            and np.array_equal(got[0], want[0])):
        raise AssertionError(f"{name}: the service's answer differs from "
                             "the direct index call")


@contextlib.contextmanager
def uncounted():
    """Launches inside are a check's (a reference scan, a direct index
    call, a kernel against its plain version), not the path's: every
    kernel count of phase 6 is put back on exit."""
    from vector_db_tpu_torch.ops.cuda.adc_probe import adc_probe_scores
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk
    from vector_db_tpu_torch.ops.cuda.sorted_topk import sorted_topk

    saved = (l2_topk.launches, l2_topk.launches_bf16, sorted_topk.launches,
             adc_probe_scores.launches, adc_topk.launches)
    try:
        yield
    finally:
        (l2_topk.launches, l2_topk.launches_bf16, sorted_topk.launches,
         adc_probe_scores.launches, adc_topk.launches) = saved


def captured(module, name, call):
    """The (args, kwargs) of every call of ``module.name`` while ``call()``
    runs; at least one."""
    seen = []
    real = getattr(module, name)

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, record)
    try:
        call()
    finally:
        setattr(module, name, real)
    if not seen:
        raise AssertionError(f"{name} was not called")
    return seen


def fold_err(kernels, name, err) -> None:
    kernel = kernels.setdefault(name, {})
    kernel["max_abs_err"] = max(kernel.get("max_abs_err", 0.0), err)


def svc_ingest(torch, say, storage, svc, nodes, n_bulk):
    """Step a: the first n_bulk nodes in one call (the bulk route), then
    SVC_BATCHES batches of SVC_BATCH (each streams and schedules a flush),
    each through StorageService.save_many and IndexingService.insert_nodes
    as the app's batch route runs them; then wait_for_flush. Before the
    first streamed batch, the insert candidate scan's l2_topk calls at that
    batch's inputs are held against the plain version. Returns a dict of
    the step's numbers."""
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk

    idx = svc.index
    routes = {"bulk_build": 0, "insert_nodes": 0, "write_snapshot": 0,
              "_schedule_flush": 0}
    for name in routes:
        owner = svc if name == "_schedule_flush" else idx
        real = getattr(owner, name)

        def counted(*a, _real=real, _name=name, **kw):
            routes[_name] += 1
            return _real(*a, **kw)
        setattr(owner, name, counted)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    storage.save_many(nodes[:n_bulk])
    t1 = time.perf_counter()
    svc.insert_nodes(nodes[:n_bulk])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if routes["bulk_build"] != 1 or routes["insert_nodes"]:
        raise AssertionError(f"ingest: the first call took {routes}, not "
                             "the bulk route")
    bulk_l2 = l2_topk.launches
    out = {"bulk_s": t2 - t0, "bulk_storage_s": t1 - t0,
           "bulk_docs_s": n_bulk / (t2 - t0), "bulk_l2": bulk_l2}
    say(f"ingest, bulk route: {n_bulk} docs in {t2 - t0:.2f} s "
        f"({out['bulk_docs_s']:.1f} docs/s; StorageService.save_many "
        f"{t1 - t0:.2f} s, IndexingService.insert_nodes -> bulk_build "
        f"{t2 - t1:.2f} s); l2_topk launches {bulk_l2} (knn_exact)")
    with uncounted():
        first = nodes[n_bulk:n_bulk + min(SVC_BATCH, 1024)]
        out["scan_err"] = insert_scan_check(
            torch, idx, np.stack([n.embedding for n in first]), say)
    secs, per_batch = [], []
    for b in range(SVC_BATCHES):
        s = n_bulk + b * SVC_BATCH
        batch = nodes[s:s + SVC_BATCH]
        lvl_before, before = idx.graph.entry_level, l2_topk.launches
        scheduled = routes["_schedule_flush"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        storage.save_many(batch)
        svc.insert_nodes(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        n_sub = math.ceil(len(batch) / 1024)
        got = l2_topk.launches - before
        lo = n_sub * (1 + lvl_before)
        hi = n_sub * (1 + idx.graph.entry_level)
        if not lo <= got <= hi or routes["bulk_build"] != 1 or \
                routes["_schedule_flush"] != scheduled + 1:
            raise AssertionError(f"ingest batch {b}: l2_topk launched {got} "
                                 f"times, not in [{lo}, {hi}], a bulk build "
                                 "or no flush scheduled")
        per_batch.append(got)
    t0 = time.perf_counter()
    svc.wait_for_flush()
    wait_s = time.perf_counter() - t0
    if routes["insert_nodes"] != SVC_BATCHES:
        raise AssertionError(f"ingest: {routes}")
    n_stream = SVC_BATCHES * SVC_BATCH
    out.update(stream_docs_s=n_stream / sum(secs), stream_ms=secs,
               l2_per_batch=per_batch, flushes=routes["write_snapshot"],
               wait_s=wait_s, peak=torch.cuda.max_memory_allocated())
    say(f"ingest, streamed route: {SVC_BATCHES} batches of {SVC_BATCH} in "
        f"{sum(secs):.2f} s ({out['stream_docs_s']:.1f} docs/s, host clock, "
        f"synced; per batch {[round(t * 1e3, 1) for t in secs]} ms); "
        f"l2_topk launches per batch {per_batch} "
        f"({math.ceil(SVC_BATCH / 1024)} insert sub-batches of <= 1024, "
        f"each 1 + the entry level); async flushes written "
        f"{routes['write_snapshot']} (latest-wins over "
        f"{routes['_schedule_flush']} scheduled), wait_for_flush "
        f"{wait_s:.2f} s; peak device memory {out['peak']} bytes "
        f"({out['peak'] / 2**30:.2f} GiB)")
    return out


def svc_searches(torch, say, svc, storage, queries, deleted):
    """Step d: the scan route (B = SVC_QUERIES), the wide route
    (B = SVC_WIDE_B), the filtered scan and single queries through the
    service, each equal to the direct index call the JAX service makes and
    held against the port's exact scan. The reference scans and the direct
    calls launch uncounted; the wide route's recall is also read at
    SVC_WIDE_EFS through search_batch_wide."""
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk

    idx = svc.index
    allowed = storage.filter_by_metadata({"tag": 3})
    with uncounted():
        before = l2_topk.launches - l2_topk.launches_bf16
        _, truth = idx.search_batch_scan(queries, K, mode="exact")
        if l2_topk.launches - l2_topk.launches_bf16 == before:
            raise AssertionError("exact scan: no l2_topk f32 launch")
        _, ftruth = idx.search_batch_scan(queries, K, mode="exact",
                                          filter_ids=allowed)
    rng = np.random.default_rng(6)
    batches = [queries + 0.01 * rng.standard_normal(queries.shape).astype(
        np.float32) for _ in range(5)]
    wb = queries[:SVC_WIDE_B]
    ef = 50     # the API's default ef
    routes = {
        "scan": (lambda q: svc.search_batch(q, K),
                 lambda q: idx.search_batch_scan(q, K, filter_ids=None),
                 batches, truth),
        "wide": (lambda q: svc.search_batch(q, K),
                 lambda q: idx.search_batch_wide(
                     q, K, ef=max(4 * max(ef, K), 64), frontier=0, steps=0,
                     seen_mask=False, filter_ids=None, schedule=None,
                     merge_kernel=True),
                 [b[:SVC_WIDE_B] for b in batches], truth[:SVC_WIDE_B]),
        "filtered": (lambda q: svc.search_batch(q, K, filter_ids=allowed),
                     lambda q: idx.search_batch_scan(q, K,
                                                     filter_ids=allowed),
                     batches, ftruth),
    }
    out = {"qps": {}, "recall": {}}
    for name, (call, direct, qbs, want) in routes.items():
        q0 = wb if name == "wide" else queries
        res = call(q0)
        with uncounted():
            same_answer(name, res, direct(q0))
        ids = res[1]
        if (ids < 0).any() or set(ids.ravel().tolist()) & deleted:
            raise AssertionError(f"{name}: a pad or a deleted id")
        if name == "filtered" and not set(ids.ravel().tolist()) <= allowed:
            raise AssertionError("filtered: a result outside the filter")
        out["recall"][name] = recall_at(ids, want)
        out["qps"][name] = median_qps(torch, call, qbs)
    floors = {"scan": SCAN_FLOOR, "filtered": SCAN_FLOOR,
              "wide": SVC_WIDE_FLOOR}
    for name, floor in floors.items():
        if out["recall"][name] < floor:
            raise AssertionError(f"{name} route: recall@{K} "
                                 f"{out['recall'][name]} < {floor}")
    say(f"searches through IndexingService: QPS {out['qps']}, recall@{K} "
        f"{out['recall']} against the port's exact scan (l2_topk f32; the "
        f"filtered one over the {len(allowed)} ids of filter_by_metadata"
        f"({{'tag': 3}})); floors {floors}; every answer equal to the "
        "direct index call; no deleted id; filtered results inside the "
        "filter")
    with uncounted():
        out["wide_efs"] = {e: recall_at(idx.search_batch_wide(
            wb, K, ef=e, frontier=0, steps=0, seen_mask=False,
            merge_kernel=True)[1], truth[:SVC_WIDE_B]) for e in SVC_WIDE_EFS}
    say(f"the wide route's {SVC_WIDE_B} queries through search_batch_wide "
        f"at the route's ef {max(4 * max(ef, K), 64)} (the API's default "
        f"ef {ef}): recall@{K} {out['recall']['wide']}; at ef "
        f"{SVC_WIDE_EFS}: {out['wide_efs']} (the same graph, frontier and "
        "steps from ef)")

    single = []
    for i in range(SVC_SINGLE_Q):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = svc.search(queries[i], k=K)
        torch.cuda.synchronize()
        single.append((time.perf_counter() - t0) * 1e3)
        if i < SVC_CHECKED:
            with uncounted():
                _, want = routes["wide"][1](queries[i:i + 1])
            if [n.id for n, _ in res] != [int(v) for v in want[0] if v >= 0]:
                raise AssertionError("single query: the service's answer "
                                     "differs from the direct index call")
    out["single_p50"] = float(np.percentile(single, 50))
    out["single_p99"] = float(np.percentile(single, 99))
    say(f"{SVC_SINGLE_Q} single-query IndexingService.search calls (the "
        f"wide route, B = 1): p50 {out['single_p50']:.3f} ms, p99 "
        f"{out['single_p99']:.3f} ms, max {max(single):.3f} ms (host clock, "
        f"synced); the first {min(SVC_CHECKED, SVC_SINGLE_Q)} equal the "
        "direct index call")
    return out


def check_l2_calls(torch, say, label, call, dtype):
    """Every l2_topk call that ``call()`` makes, at its own inputs, against
    l2_topk_plain; each over a table of ``dtype``. Returns the max abs
    err."""
    from vector_db_tpu_torch.ops import exact
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk, l2_topk_plain

    err = 0.0
    for (q, tab, valid, k), opts in captured(exact, "l2_topk", call):
        sq = opts.get("x_sq")
        if sq is None:
            sq = (tab.float() * tab.float()).sum(-1)
        name = (f"{label}: l2_topk {tab.dtype} n={tab.shape[0]} "
                f"d={tab.shape[1]} b={q.shape[0]} k={k}, "
                f"{int(valid.sum())} valid rows")
        if tab.dtype != dtype:
            raise AssertionError(f"{name}: not over a {dtype} table")
        e = check_topk(name, *l2_topk(q, tab, valid, k, x_sq=sq),
                       *l2_topk_plain(q, tab, valid, k + 1, sq), group=k,
                       scale=((q * q).sum(-1) + sq.max()).cpu().numpy())
        say(f"{name} against l2_topk_plain: max abs err {e}")
        err = max(err, e)
    return err


def svc_kernel_checks(torch, say, svc, queries, allowed):
    """The kernels at the inputs the service's search routes give them,
    held against their plain versions, uncounted: l2_topk over the bf16
    scan mirror (the scan route, and the filtered one with the filter in
    its mask), and sorted_topk on every merge of the wide route (B =
    SVC_WIDE_B and a single query). Returns {kernel: max abs err}."""
    from vector_db_tpu_torch.index import wide_beam
    from vector_db_tpu_torch.ops.cuda.sorted_topk import (
        sorted_topk, sorted_topk_plain)

    errs = {"l2_topk_bf16": 0.0, "sorted_topk": 0.0}
    with uncounted():
        for label, kw in (("scan", {}), ("filtered", {"filter_ids": allowed})):
            errs["l2_topk_bf16"] = max(errs["l2_topk_bf16"], check_l2_calls(
                torch, say, f"service {label} route",
                lambda: svc.search_batch(queries, K, **kw), torch.bfloat16))
        for label, call in (
                (f"B = {SVC_WIDE_B}",
                 lambda: svc.search_batch(queries[:SVC_WIDE_B], K)),
                ("B = 1", lambda: svc.search(queries[0], k=K))):
            calls = captured(wide_beam, "sorted_topk", call)
            shapes, err = set(), 0.0
            for args, opts in calls:
                d, v, topk = args[:3]
                shapes.add((str(d.dtype), *d.shape, topk))
                err = max(err, check_sorted(
                    f"service wide route {label}: sorted_topk",
                    sorted_topk(*args, **opts),
                    sorted_topk_plain(d, v, topk + 1)))
            say(f"service wide route {label}: sorted_topk on its "
                f"{len(calls)} merges (keys dtype, B, width, topk: "
                f"{sorted(shapes)}) against sorted_topk_plain: keys equal, "
                f"payloads equal within runs of equal keys, max abs err "
                f"{err}")
            errs["sorted_topk"] = max(errs["sorted_topk"], err)
    return errs


def svc_small_types(torch, say, tmp, x, queries):
    """Step e: a flat (f32) and an IVF-PQ service over the first
    SVC_SMALL_N rows; their answers equal the direct index calls (made
    uncounted), and adc_probe at the IVF route's inputs equals its plain
    version."""
    from vector_db_tpu_torch.index import ivf as ivf_index
    from vector_db_tpu_torch.ops.cuda.adc_probe import (
        adc_probe_plain, adc_probe_scores)
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.storage import InMemoryNodeStorage
    from vector_db_tpu_torch.types import Node

    nodes = [Node(id=i, embedding=x[i]) for i in range(SVC_SMALL_N)]
    flat_ids = None
    out = {}
    for kind, extra in (("flat", {}),
                        ("ivf", {"ivf_k": SVC_IVF_K,
                                 "pq": {"chunks": SVC_PQ_M,
                                        "min_size": SVC_MIN_SIZE}})):
        cfg = svc_config(tmp / f"{kind}.yaml", tmp / kind, type=kind, **extra)
        counts = (l2_topk.launches - l2_topk.launches_bf16,
                  adc_probe_scores.launches)
        t0 = time.perf_counter()
        svc = IndexingService(storage=InMemoryNodeStorage(), config_path=cfg,
                              index_file=str(tmp / f"{kind}.npz"))
        svc.insert_nodes(nodes)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = svc.search_batch(queries, K)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launched = (l2_topk.launches - l2_topk.launches_bf16 - counts[0],
                    adc_probe_scores.launches - counts[1])
        with uncounted():
            if kind == "flat":
                want = svc.index.search_batch(queries, K, filter_ids=None)
                flat_ids = got[1]
                out["l2_err"] = check_l2_calls(
                    torch, say, "flat service",
                    lambda: svc.search_batch(queries, K), torch.float32)
            else:
                if not svc._pq_active:
                    raise AssertionError("ivf: PQ did not activate")
                want = svc.index.search_batch(queries, n_probe=10, top_k=K,
                                              filter_ids=None, pq=True,
                                              adc="pallas")
                out["adc_err"] = 0.0
                calls = captured(ivf_index, "adc_probe_scores",
                                 lambda: svc.search_batch(queries, K))
                for (lut, codes, corr, ok), _ in calls:
                    out["adc_err"] = max(out["adc_err"], check_topk(
                        "ivf service: adc_probe", adc_probe_scores(
                            lut, codes, corr, ok), None,
                        adc_probe_plain(lut, codes, corr, ok), None,
                        group=codes.shape[1], scale=adc_terms(lut, corr)))
                say(f"ivf service: adc_probe on its {len(calls)} query "
                    f"blocks (B = {lut.shape[0]} at the last, P = "
                    f"{codes.shape[1]}, m = {codes.shape[2]}, ksub = "
                    f"{lut.shape[2]}) against adc_probe_plain: max abs err "
                    f"{out['adc_err']}")
        same_answer(kind, got, want)
        if launched[0 if kind == "flat" else 1] <= 0:
            raise AssertionError(f"{kind}: its kernel did not launch")
        out[kind] = {"ingest_s": ingest_s, "first_search_s": first_s,
                     "qps": median_qps(torch, lambda q: svc.search_batch(
                         q, K), [queries] * 5),
                     "recall": recall_at(got[1], flat_ids),
                     "l2_topk_f32": launched[0], "adc_probe": launched[1]}
        say(f"{kind} service at {SVC_SMALL_N} x {SVC_DIM}: ingest "
            f"{ingest_s:.2f} s, first search {first_s:.2f} s"
            + (" (PQ training included)" if kind == "ivf" else "")
            + f", QPS {out[kind]['qps']:.1f} at B = {len(queries)}, "
            f"recall@{K} {out[kind]['recall']:.4f} against the flat "
            f"service; equal to the direct index call; launches l2_topk f32 "
            f"{launched[0]}, adc_probe {launched[1]}")
        if kind == "ivf":
            out["ivf_full"] = svc_ivf_full_scan(torch, say, svc, queries,
                                                flat_ids)
        del svc
    out["rp"] = svc_ivf_rp(torch, say, tmp, nodes, queries, flat_ids)
    out["hnsw"] = svc_hnsw_modes(torch, say, tmp, nodes, queries, flat_ids)
    return out


def svc_ivf_full_scan(torch, say, svc, queries, flat_ids):
    """Step e, the IVF-PQ service at n_probe = ivf_k: the full-scan
    IVF-PQ route (adc_topk with its row and group terms), equal to the
    direct index call; its adc_topk calls held against the plain version
    on ADC_CHECK_B queries, uncounted. Returns its numbers."""
    from vector_db_tpu_torch.index import ivf as ivf_index
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk, adc_topk_plain

    before = adc_topk.launches
    got = svc.search_batch(queries, K, n_probe=SVC_IVF_K)
    launched = adc_topk.launches - before
    err = 0.0
    with uncounted():
        want = svc.index.search_batch(queries, n_probe=SVC_IVF_K, top_k=K,
                                      filter_ids=None, pq=True, rp=False,
                                      adc="pallas")
        calls = captured(ivf_index, "adc_topk", lambda: svc.search_batch(
            queries, K, n_probe=SVC_IVF_K))
        for (lut, codes, valid, k), opts in calls:
            sub = dict(opts, group_bias=opts["group_bias"][:ADC_CHECK_B])
            ls = lut[:ADC_CHECK_B]
            err = max(err, check_topk(
                "ivf service full scan: adc_topk", *adc_topk(
                    ls, codes, valid, k, **sub),
                *adc_topk_plain(ls, codes, valid, k + 1, **sub), group=k,
                scale=(ls.amax(-1).sum(-1) + opts["row_bias"].abs().max()
                       + sub["group_bias"].abs().amax(-1)).cpu().numpy()))
    same_answer("ivf service full scan", got, want)
    if launched != 1:
        raise AssertionError(f"ivf full scan: adc_topk launched {launched} "
                             "times, not once")
    out = {"qps": median_qps(torch, lambda q: svc.search_batch(
        q, K, n_probe=SVC_IVF_K), [queries] * 5),
           "recall": recall_at(got[1], flat_ids), "adc_topk": launched,
           "adc_err": err}
    say(f"ivf service at n_probe = ivf_k = {SVC_IVF_K} (the full-scan "
        f"IVF-PQ): QPS {out['qps']:.1f}, recall@{K} {out['recall']:.4f} "
        f"against the flat service, equal to the direct index call; "
        f"adc_topk launched {launched} time(s), against adc_topk_plain on "
        f"{ADC_CHECK_B} queries (N = {codes.shape[0]} slots, group "
        f"{opts['group']}): max abs err {err}")
    return out


def svc_ivf_rp(torch, say, tmp, nodes, queries, flat_ids):
    """Step e, an IVF service with index.rp {dims 128}: n_probe 10 (the
    probe) and n_probe = ivf_k (the full scan, on the route the residual
    ratio picks), each equal to the direct index call; where it is the
    flat route, its l2_topk bf16 calls held against the plain version,
    uncounted. Returns its numbers."""
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.storage import InMemoryNodeStorage

    cfg = svc_config(tmp / "ivf_rp.yaml", tmp / "ivf_rp", type="ivf",
                     ivf_k=SVC_IVF_K, rp={"dims": RP_DIMS,
                                          "min_size": SVC_MIN_SIZE})
    svc = IndexingService(storage=InMemoryNodeStorage(), config_path=cfg,
                          index_file=str(tmp / "ivf_rp.npz"))
    t0 = time.perf_counter()
    svc.insert_nodes(nodes)
    svc.search_batch(queries[:8], K)             # activates RP
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if not svc._rp_active:
        raise AssertionError("ivf rp: RP did not activate")
    ratio = svc.index._rp_res_ratio
    route = "flat" if ratio > 0.5 else "cell-block scan"
    out = {"ingest_s": ingest_s, "ratio": ratio, "route": route}
    for n_probe in (10, SVC_IVF_K):
        before = l2_topk.launches_bf16
        got = svc.search_batch(queries, K, n_probe=n_probe)
        launched = l2_topk.launches_bf16 - before
        with uncounted():
            want = svc.index.search_batch(queries, n_probe=n_probe, top_k=K,
                                          filter_ids=None, pq=False, rp=True,
                                          adc="pallas")
        same_answer(f"ivf rp service n_probe {n_probe}", got, want)
        out[n_probe] = {"qps": median_qps(torch, lambda q: svc.search_batch(
            q, K, n_probe=n_probe), [queries] * 5),
            "recall": recall_at(got[1], flat_ids), "l2_topk_bf16": launched}
    full = out[SVC_IVF_K]
    if route == "flat":
        if full["l2_topk_bf16"] != 1:
            raise AssertionError("ivf rp flat route: l2_topk bf16 launched "
                                 f"{full['l2_topk_bf16']} times")
        with uncounted():
            out["l2_err"] = check_l2_calls(
                torch, say, "ivf rp service, flat route",
                lambda: svc.search_batch(queries, K, n_probe=SVC_IVF_K),
                torch.bfloat16)
    say(f"ivf rp service at {SVC_SMALL_N} x {SVC_DIM} (index.rp dims "
        f"{RP_DIMS}): ingest and enable_rp {ingest_s:.2f} s; residual ratio "
        f"{ratio:.4f}, so the full scan takes the {route} route; n_probe 10 "
        f"QPS {out[10]['qps']:.1f} recall@{K} {out[10]['recall']:.4f}; "
        f"n_probe {SVC_IVF_K} QPS {full['qps']:.1f} recall@{K} "
        f"{full['recall']:.4f} (l2_topk bf16 launches {full['l2_topk_bf16']}"
        f"); each equal to the direct index call")
    del svc
    return out


def svc_hnsw_modes(torch, say, tmp, nodes, queries, flat_ids):
    """Step e, HNSW services at SVC_SMALL_N rows with index.rp, then
    index.pq, then index.wide.mode: beam; single queries (the rp and pq
    routes are the JAX service's single-query routes) and a batch (beam),
    each equal to the direct index call. Returns their numbers."""
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.storage import InMemoryNodeStorage

    out = {}
    configs = {
        "rp": dict(rp={"dims": RP_DIMS, "min_size": SVC_MIN_SIZE}),
        "pq": dict(pq={"chunks": SVC_PQ_M, "min_size": SVC_MIN_SIZE}),
        "beam": dict(wide={"enabled": True, "dims": INLINE_DIMS,
                           "seeds": 4096, "mode": "beam",
                           "min_size": SVC_MIN_SIZE})}
    for mode, extra in configs.items():
        cfg = svc_config(tmp / f"hnsw_{mode}.yaml", tmp / f"hnsw_{mode}",
                         type="hnsw", **extra)
        svc = IndexingService(storage=InMemoryNodeStorage(), config_path=cfg,
                              index_file=str(tmp / f"hnsw_{mode}.npz"))
        t0 = time.perf_counter()
        svc.insert_nodes(nodes)
        svc.search(queries[0], k=K)                # activates the mode
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        idx = svc.index
        if mode == "beam":
            got = svc.search_batch(queries, K)
            with uncounted():
                want = idx.search_batch_beam(queries, K, frontier=224,
                                             steps=12, hist=2)
            same_answer("hnsw beam service", got, want)
            ids = got[1]
            qps = median_qps(torch, lambda q: svc.search_batch(q, K),
                             [queries] * 5)
        else:
            call = getattr(idx, f"search_batch_{mode}")
            rows, secs = [], []
            for i, q in enumerate(queries[:SVC_CHECKED * 5]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hits = svc.search(q, k=K)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                rows.append([n.id for n, _ in hits])
                if i < SVC_CHECKED:
                    with uncounted():
                        d, w = call(q[None, :], K, ef=50, expand=4)
                    if [n.id for n, _ in hits] != [int(v) for v in w[0]
                                                   if v >= 0] or not \
                            np.allclose([dd for _, dd in hits],
                                        d[0][:len(hits)], rtol=1e-6):
                        raise AssertionError(f"hnsw {mode} service: the "
                                             "answer differs from the direct "
                                             "index call")
            ids = np.array([r + [-1] * (K - len(r)) for r in rows])
            qps = 1.0 / statistics.median(secs)
        n_q = len(ids)
        out[mode] = {"ingest_s": ingest_s, "qps": qps,
                     "recall": recall_at(ids, flat_ids[:n_q])}
        say(f"hnsw {mode} service at {SVC_SMALL_N} x {SVC_DIM}: ingest and "
            f"activation {ingest_s:.2f} s; "
            + (f"B = {n_q} QPS {qps:.1f}" if mode == "beam" else
               f"{n_q} single queries, {qps:.1f} a second (median)")
            + f"; recall@{K} {out[mode]['recall']:.4f} against the flat "
            "service; equal to the direct index call")
        del svc
    return out


def svc_http(torch, say, cfg, storage, svc, texts):
    """Step f: the port's app over the restarted services, in process on
    127.0.0.1, driven by an HTTP client one request at a time: requests/s
    per route; the embedded documents are found, /health counts them and
    /stats names the card."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from vector_db_tpu_torch.api.app import create_app
    from vector_db_tpu_torch.services.embedding_service import (
        EmbeddingService)

    n = SVC_HTTP
    rates = {}

    async def timed(route, count, send):
        t0 = time.perf_counter()
        for i in range(count):
            r = await send(i)
            if r.status != 200:
                raise AssertionError(f"{route}: HTTP {r.status} "
                                     f"{await r.text()}")
            body = await r.json()
        rates[route] = count / (time.perf_counter() - t0)
        return body

    async def drive():
        # the kernels are built and the mirrors warm by now: the app's own
        # warm-up search is off (it would print a line of its own)
        os.environ["VDB_TPU_WARMUP"] = "0"
        app = create_app(config_path=cfg,
                         embedding_client=EmbeddingService(cfg),
                         storage_service=storage, indexing_service=svc)
        client = TestClient(TestServer(app, host="127.0.0.1"))
        await client.start_server()
        size0 = svc.get_index_size()
        await timed("POST /embed", n["embed"], lambda i: client.post(
            "/embed", json={"content": texts[i], "metadata": {"tag": 99}}))
        await timed("POST /embed/batch-docs", n["batch_docs"],
                    lambda i: client.post("/embed/batch-docs", json={
                        "contents": [f"http batch doc {i} {j}" for j in
                                     range(n["batch_docs_size"])]}))
        body = await timed("POST /search", n["search"], lambda i: client.post(
            "/search", json={"query": texts[i % n["embed"]], "top_k": K}))
        if body["results"][0]["content"] != texts[(n["search"] - 1)
                                                  % n["embed"]]:
            raise AssertionError("/search: an embedded doc is not its own "
                                 "top-1")
        body = await timed("POST /search/batch", n["search_batch"],
                           lambda i: client.post("/search/batch", json={
                               "queries": texts[:n["embed"]], "top_k": K,
                               "metadata_filter": {"tag": 99}}))
        if [r[0]["content"] for r in body["results"]] != \
                texts[:n["embed"]]:
            raise AssertionError("/search/batch: wrong top-1")
        health = await timed("GET /health", n["health"],
                             lambda i: client.get("/health"))
        stats = await timed("GET /stats", n["stats"],
                            lambda i: client.get("/stats"))
        await client.close()
        grown = n["embed"] + n["batch_docs"] * n["batch_docs_size"]
        if health["index_size"] != size0 + grown:
            raise AssertionError(f"/health: {health}")
        name = torch.cuda.get_device_name(0)
        if not any(name in d for d in stats["device"]["devices"]):
            raise AssertionError(f"/stats does not name {name}: {stats}")
        return stats

    stats = asyncio.run(drive())
    say(f"HTTP app (create_app over the restarted services, aiohttp on "
        f"127.0.0.1, one request at a time): requests/s "
        f"{ {k: round(v, 1) for k, v in rates.items()} }; /stats device "
        f"{stats['device']['devices']}")
    return rates


def phase_services(torch, kernels, card):
    """Phase 6: the port's services at the deployment of config.yaml
    (MiniLM-L6 widths, d = 384, capacity 1,000,000, HNSW M 16 /
    ef_construction 200, flush_threshold 1000) on the card. The kernels'
    checks at the routes' inputs fold into ``kernels``' max_abs_err."""
    import functools
    import tempfile
    from pathlib import Path

    from vector_db_tpu_torch import embedding_like
    from vector_db_tpu_torch.services import storage_service
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.storage import MMapNodeStorage
    from vector_db_tpu_torch.types import Node

    def say(msg):  # with the seconds since the phase began
        log(f"{msg} (+{time.perf_counter() - t_phase:.1f} s) [{card}]")

    t_phase = t0 = time.perf_counter()
    x = embedding_like(SVC_N + SVC_QUERIES, SVC_DIM, seed=2, device="numpy")
    queries = np.ascontiguousarray(x[SVC_N:])
    x = x[:SVC_N]
    nodes = [Node(id=i, embedding=x[i], metadata={"tag": i % SVC_TAGS})
             for i in range(SVC_N)]
    n_bulk = SVC_N - SVC_BATCHES * SVC_BATCH - SVC_SINGLE
    say(f"corpus {SVC_N} x {SVC_DIM} (embedding_like seed 2), {SVC_QUERIES} "
        f"queries and {SVC_N} Nodes made ({time.perf_counter() - t0:.1f} s, "
        "host)")
    real_mmap = storage_service.MMapNodeStorage
    storage_service.MMapNodeStorage = functools.partial(
        MMapNodeStorage, content_chars=SVC_FIELD_CHARS,
        metadata_chars=SVC_FIELD_CHARS)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            cfg = svc_config(tmp / "config.yaml", tmp / "vdb", **svc_hnsw())
            # the services' path: counts at 0 just before it
            _reset_counts()
            storage = storage_service.StorageService(
                str(tmp / "vdb"), dim=SVC_DIM, capacity=SVC_N)
            svc = IndexingService(storage=storage.storage, config_path=cfg)
            a = svc_ingest(torch, say, storage, svc, nodes, n_bulk)
            fold_err(kernels, "l2_topk", a["scan_err"])

            # b: restart on the same files
            storage.close()
            del svc, storage
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            storage = storage_service.StorageService(
                str(tmp / "vdb"), dim=SVC_DIM, capacity=SVC_N)
            t1 = time.perf_counter()
            svc = IndexingService(storage=storage.storage, config_path=cfg)
            t2 = time.perf_counter()
            first = svc.search(queries[0], k=K)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            size = n_bulk + SVC_BATCHES * SVC_BATCH
            if not svc.is_index_loaded() or svc.get_index_size() != size \
                    or storage.size() != size or not first:
                raise AssertionError(f"restart: loaded "
                                     f"{svc.is_index_loaded()}, size "
                                     f"{svc.get_index_size()}, not {size}")
            say(f"restart: time to serve {serve_s:.2f} s (StorageService "
                f"{t1 - t0:.2f} s with the metadata index, IndexingService "
                f"{t2 - t1:.2f} s: npz, hydration, recover_unlinked; the "
                f"first search {serve_s - (t2 - t0):.2f} s, enable_wide "
                f"included); index_loaded, size {size}")

            # c: single documents, each past the threshold (sync save)
            single = []
            for node in nodes[size:]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                storage.save(node)
                svc.insert_node(node)
                torch.cuda.synchronize()
                single.append((time.perf_counter() - t0) * 1e3)
            npz = os.path.getsize(svc.index_file)
            if svc.get_index_size() != SVC_N or svc._index_modified:
                raise AssertionError("single inserts: size or save")
            with uncounted():
                _, top1 = svc.index.search_batch_scan(queries[:SVC_DELETE],
                                                      1, mode="exact")
            deleted = set(top1[:, 0].tolist())
            for i in deleted:
                svc.delete_node(i)
            # the wide route's mirror rebuilds after every write
            after_write = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                svc.search(queries[0], k=K)
                torch.cuda.synchronize()
                after_write.append((time.perf_counter() - t0) * 1e3)
            say(f"{SVC_SINGLE} single inserts (StorageService.save + "
                f"IndexingService.insert_node, each saving {npz} bytes of "
                f"npz): p50 {np.percentile(single, 50):.1f} ms, max "
                f"{max(single):.1f} ms; size {SVC_N}; deleted {len(deleted)}"
                f" ids (the exact top-1 of {SVC_DELETE} queries); the first "
                f"single query after the writes {after_write[0]:.1f} ms "
                f"(the wide mirror rebuilt), the next {after_write[1]:.1f} "
                "ms")

            # d: searches through the service
            d = svc_searches(torch, say, svc, storage, queries, deleted)
            counts = _counts()
            _launched("services'", counts,
                      ("l2_topk", "l2_topk_bf16", "sorted_topk"))
            say(f"launches of the services' own calls (ingest, restart, "
                f"single inserts, deletes, searches through IndexingService;"
                f" the reference scans, direct index calls and plain checks "
                f"excluded): {counts}")
            errs = svc_kernel_checks(torch, say, svc, queries,
                                     storage.filter_by_metadata({"tag": 3}))
            for name, err in errs.items():
                fold_err(kernels, name, err)
            e = svc_small_types(torch, say, tmp, x, queries)
            fold_err(kernels, "adc_probe", e["adc_err"])
            fold_err(kernels, "l2_topk", e["l2_err"])
            fold_err(kernels, "adc_topk", e["ivf_full"]["adc_err"])
            fold_err(kernels, "l2_topk_bf16", e["rp"].get("l2_err", 0.0))
            if e["ivf"]["adc_probe"] <= 0:
                raise AssertionError("adc_probe: no launch on the IVF route")
            f = svc_http(torch, say, cfg, storage, svc,
                         [f"http doc {i}" for i in range(SVC_HTTP["embed"])])
            scan_rows = profile(torch, "service scan route (B = "
                                f"{SVC_QUERIES})", lambda: svc.search_batch(
                                    queries, K))
            single_rows = profile(torch, "service single query",
                                  lambda: svc.search(queries[1], k=K))
            say(f"phase 6 ok ({time.perf_counter() - t_phase:.1f} s)")
            t_phase = time.perf_counter()
            at = svc_autotune(torch, say, tmp, storage, svc, x, queries,
                              kernels)
            say(f"phase 7a ok ({time.perf_counter() - t_phase:.1f} s)")
            storage.close()
    finally:
        storage_service.MMapNodeStorage = real_mmap
    say(f"services summary: ingest docs/s bulk {a['bulk_docs_s']:.1f}, "
        f"streamed {a['stream_docs_s']:.1f} (storage fields "
        f"{SVC_FIELD_CHARS} characters); flushes {a['flushes']}; time to "
        f"serve {serve_s:.2f} s; single insert p50 "
        f"{np.percentile(single, 50):.1f} / max {max(single):.1f} ms; QPS "
        f"{d['qps']}; recall@{K} {d['recall']} (wide at ef "
        f"{d['wide_efs']}); single query p50 "
        f"{d['single_p50']:.3f} / p99 {d['single_p99']:.3f} ms; ingest peak "
        f"{a['peak']} bytes; launches {counts}, adc_probe "
        f"{e['ivf']['adc_probe']}; plain-check max abs err {errs}, "
        f"insert scan {a['scan_err']}, flat l2_topk {e['l2_err']}, "
        f"adc_probe {e['adc_err']}; flat "
        f"{e['flat']['qps']:.1f} QPS, IVF-PQ "
        f"{e['ivf']['qps']:.1f} QPS recall {e['ivf']['recall']:.4f}; HTTP "
        f"requests/s { {k: round(v, 1) for k, v in f.items()} }; profiled "
        f"{len(scan_rows)} + {len(single_rows)} device rows; phase 7a: "
        f"time to serve {at['serve_s']:.2f} s, routed "
        f"{ {b: (r['mode'], round(r['recall'], 4))
             for b, r in at['routed'].items()} }, IVF n_probe "
        f"{at['ivf']['n_probe']} recall {at['ivf']['recall']:.4f}")
    return {"index": svc.index, "x": x, "queries": queries,
            "deleted": deleted}


def _reset_counts():
    """Every kernel count to 0: a path's own launches follow."""
    from vector_db_tpu_torch.ops.cuda.adc_probe import adc_probe_scores
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk
    from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan
    from vector_db_tpu_torch.ops.cuda.block_topm import block_topm_scan
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk
    from vector_db_tpu_torch.ops.cuda.sorted_topk import sorted_topk

    l2_topk.launches = l2_topk.launches_bf16 = 0
    sorted_topk.launches = adc_probe_scores.launches = adc_topk.launches = 0
    block_min_scan.launches = block_topm_scan.launches = 0


def _counts():
    """Each kernel's launches since the last _reset_counts."""
    from vector_db_tpu_torch.ops.cuda import launch_counts

    return launch_counts()


def _launched(path, counts, names) -> None:
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{name}: no launch on the {path} path")


def _timed_decisions(tuner):
    """Wrap ``tuner.decision_for`` to record each calibration's seconds
    under its /stats key; returns the dict it fills."""
    secs = {}
    real = tuner.decision_for

    def timed(service, batch_size, target=None, sel_frac=None):
        before = len(tuner._decisions)
        t0 = time.perf_counter()
        dec = real(service, batch_size, target, sel_frac)
        if len(tuner._decisions) > before:
            secs[f"b{dec['bucket']}@{dec['target']:g}" + (
                f"/sel{dec['selectivity']:g}" if "selectivity" in dec
                else "")] = time.perf_counter() - t0
        return dec

    tuner.decision_for = timed
    return secs


def _stats_over_http(cfg, storage, svc):
    """GET /stats of the app over ``svc``, on 127.0.0.1: the JSON body."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from vector_db_tpu_torch.api.app import create_app
    from vector_db_tpu_torch.services.embedding_service import (
        EmbeddingService)

    async def get():
        os.environ["VDB_TPU_WARMUP"] = "0"
        client = TestClient(TestServer(create_app(
            config_path=cfg, embedding_client=EmbeddingService(cfg),
            storage_service=storage, indexing_service=svc),
            host="127.0.0.1"))
        await client.start_server()
        r = await client.get("/stats")
        if r.status != 200:
            raise AssertionError(f"/stats: HTTP {r.status}")
        body = await r.json()
        await client.close()
        return body

    return asyncio.run(get())


def routed_floor(name, rec, dec) -> None:
    """A routed call's recall is at least its decision's target less
    AT_SLACK, or, where no candidate met the target, the recall the chosen
    one measured in calibration less AT_SLACK."""
    floor = min(dec["target"], dec["recall"]) - AT_SLACK
    if rec < floor:
        raise AssertionError(f"{name}: routed recall {rec} < {floor} "
                             f"({dec['mode']} {dec['params']})")


def svc_autotune(torch, say, tmp, storage, svc, x, queries, kernels):
    """Phase 7a: phase 6's HNSW service restarted from its files with
    index.autotune on (target AT_TARGET, AT_SAMPLE calibration queries,
    k = K, the default ef ladder), then the IVF-PQ service of step e with
    it. Records the time to serve, every decision table (each candidate's
    recall and QPS, the calibration seconds) for B = 1000, 64 and single
    queries and for a filtered batch (tag == 3, selectivity 0.1), the
    routed calls' QPS and recall against the port's f32 scan on fresh
    perturbed queries (each held to ``routed_floor``),
    /stats over HTTP and the routed path's launches; the ground truth's
    l2_topk calls are held against the plain version, uncounted. Returns
    the step's numbers."""
    from vector_db_tpu_torch.ops import exact
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.storage import InMemoryNodeStorage
    from vector_db_tpu_torch.types import Node

    svc.wait_for_flush()
    svc.force_save_index()
    autotune = {"target_recall": AT_TARGET, "sample": AT_SAMPLE, "k": K,
                "min_size": SVC_MIN_SIZE}
    cfg = svc_config(tmp / "autotune.yaml", tmp / "vdb",
                     **svc_hnsw(autotune=autotune))
    rng = np.random.default_rng(8)
    fresh = queries + 0.01 * rng.standard_normal(queries.shape).astype(
        np.float32)
    allowed = storage.filter_by_metadata({"tag": 3})
    gc.collect()
    torch.cuda.empty_cache()
    # the autotuned service's path: counts at 0 just before it
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at = IndexingService(storage=storage.storage, config_path=cfg)
    secs = _timed_decisions(at._autotune)
    first = at.search(fresh[0], k=K)        # calibrates the B = 1 table
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if not at.is_index_loaded() or not first:
        raise AssertionError("autotune restart: no index or no answer")
    with uncounted():
        _, truth = at.index.search_batch_scan(fresh, K, mode="exact")
        _, ftruth = at.index.search_batch_scan(fresh, K, mode="exact",
                                               filter_ids=allowed)
    out = {"serve_s": serve_s, "routed": {}}
    for b in AT_BATCHES:
        n = AT_SINGLE_Q if b == 1 else len(fresh)
        dec = at._autotune.decision_for(at, b)
        got = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, n, b):
            if b == 1:
                got.append([nd.id for nd, _ in at.search(fresh[s], k=K)])
            else:
                got.extend(at.search_batch(fresh[s:s + b], K)[1].tolist())
        torch.cuda.synchronize()
        qps = n / (time.perf_counter() - t0)
        rec = recall_at(np.asarray(got), truth[:n])
        out["routed"][b] = {"mode": dec["mode"], "params": dec["params"],
                            "qps": qps, "recall": rec}
        routed_floor(f"autotune B = {b}", rec, dec)
    at.search_batch(fresh, K, filter_ids=allowed)      # calibrates
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = at.search_batch(fresh, K, filter_ids=allowed)
    torch.cuda.synchronize()
    fqps = len(fresh) / (time.perf_counter() - t0)
    if not set(res[1][res[1] >= 0].tolist()) <= allowed:
        raise AssertionError("autotune filtered: a result outside the "
                             "filter")
    frec = recall_at(res[1], ftruth)
    fdec = next(d for key, d in at._autotune._decisions.items()
                if key[2] < 1.0)
    out["routed"]["filtered"] = {"mode": fdec["mode"],
                                 "params": fdec["params"], "qps": fqps,
                                 "recall": frec}
    routed_floor("autotune filtered", frec, fdec)
    counts = _counts()
    _launched("autotuned service's", counts,
              ("l2_topk", "l2_topk_bf16", "sorted_topk"))
    tables = at._autotune.stats()
    for key, dec in zip(tables, at._autotune._decisions.values()):
        say(f"autotune table {key}: calibrated in {secs[key]:.2f} s at "
            f"size {dec['calibrated_at_size']}; chose {dec['mode']} "
            f"{dec['params']} (recall {dec['recall']}, {dec['qps']} QPS, met "
            f"{dec['met']}); candidates " + "; ".join(
                f"{c['name']} {c['params']} recall {c['recall']} qps "
                f"{c['qps']}" for c in dec["candidates"]))
    stats = _stats_over_http(cfg, storage, at)["index"]["autotune"]
    if stats != json.loads(json.dumps(tables)):
        raise AssertionError(f"/stats autotune: {sorted(stats)}")
    with uncounted():
        err = check_l2_calls(
            torch, say, "autotune ground truth",
            lambda: at._autotune._draw_calibration(at.index), torch.float32)
    fold_err(kernels, "l2_topk", err)
    routed = {b: {k: round(v, 4) if isinstance(v, float) else v
                  for k, v in r.items()} for b, r in out["routed"].items()}
    say(f"autotuned HNSW service (phase 6's files, index.autotune target "
        f"{AT_TARGET}, sample {AT_SAMPLE}, k {K}): time to serve "
        f"{serve_s:.2f} s (the B = 1 calibration included); routed calls "
        f"on {len(fresh)} fresh perturbed queries ({AT_SINGLE_Q} at B = 1), "
        f"recall@{K} against the f32 scan and QPS (host clock): {routed}; "
        f"/stats over HTTP carries the tables {sorted(stats)}; launches "
        f"{counts}")
    del at
    gc.collect()
    torch.cuda.empty_cache()

    # the IVF-PQ service of step e, with index.autotune on
    nodes = [Node(id=i, embedding=x[i]) for i in range(SVC_SMALL_N)]
    cfg = svc_config(tmp / "at_ivf.yaml", tmp / "at_ivf", type="ivf",
                     ivf_k=SVC_IVF_K, autotune=autotune,
                     pq={"chunks": SVC_PQ_M, "min_size": SVC_MIN_SIZE})
    _reset_counts()
    ivf = IndexingService(storage=InMemoryNodeStorage(), config_path=cfg,
                          index_file=str(tmp / "at_ivf.npz"))
    secs = _timed_decisions(ivf._autotune)
    ivf.insert_nodes(nodes)
    got = ivf.search_batch(fresh, K)
    counts = _counts()
    _launched("autotuned IVF-PQ service's", counts, ("adc_probe", "adc_topk"))
    with uncounted():
        _, slots = exact.exact_search(
            torch.from_numpy(fresh).to(ivf.index._emb.device),
            ivf.index._emb, ivf.index._has_emb, K)
        itruth = ivf.index._store.ids_of(slots.cpu().numpy())
    dec = next(iter(ivf._autotune._decisions.values()))
    rec = recall_at(got[1], itruth)
    qps = median_qps(torch, lambda q: ivf.search_batch(q, K), [fresh] * 5)
    out["ivf"] = {"n_probe": dec["params"]["n_probe"], "recall": rec,
                  "qps": qps, "cal_s": next(iter(secs.values()))}
    routed_floor("autotune ivf", rec, dec)
    say(f"autotuned IVF-PQ service ({SVC_SMALL_N} x {SVC_DIM}, ivf_k "
        f"{SVC_IVF_K}, PQ m {SVC_PQ_M}): calibrated in "
        f"{out['ivf']['cal_s']:.2f} s; chose {dec['params']} (recall "
        f"{dec['recall']}, {dec['qps']} QPS); candidates " + "; ".join(
            f"n_probe {c['params']['n_probe']} recall {c['recall']} qps "
            f"{c['qps']}" for c in dec["candidates"])
        + f"; routed B = {len(fresh)}: recall@{K} {rec:.4f} against the f32 "
        f"scan, {qps:.1f} QPS; launches {counts}")
    return out


def sharded_flat(torch, say, kernels, mesh, x, queries, live, batches):
    """Phase 7b, a: ShardedFlatIndex over the rows, against the
    single-device f32 scan (ids between apart values, distances within
    1e-5), its l2_topk calls against the plain version (uncounted), and
    the 2 x 2 mesh's answers against the 1-D mesh's. Returns (QPS, its
    answers)."""
    from vector_db_tpu_torch.ops.exact import exact_search
    from vector_db_tpu_torch.parallel.mesh import make_mesh_2d
    from vector_db_tpu_torch.parallel.sharded import ShardedFlatIndex

    dev = mesh.devices[0]
    cap = SVC_N // SH_SHARDS
    answers = []
    for grid in (mesh, make_mesh_2d(2, SH_SHARDS // 2,
                                    devices=mesh.devices)):
        flat = ShardedFlatIndex(mesh=grid, dim=SVC_DIM,
                                capacity_per_shard=cap)
        for s in range(0, SVC_N, 100_000):
            flat.insert(range(s, min(s + 100_000, SVC_N)), x[s:s + 100_000])
        for i in np.nonzero(~live)[0]:
            flat.delete(int(i))
        answers.append(flat.search_batch(queries, K))
        if grid is mesh:
            qps = median_qps(torch, lambda q: flat.search_batch(q, K),
                             batches)
            with uncounted():
                fold_err(kernels, "l2_topk", check_l2_calls(
                    torch, say, "sharded flat",
                    lambda: flat.search_batch(queries, K), torch.float32))
        del flat
    same_answer("2 x 2 mesh ShardedFlatIndex", answers[1], answers[0])
    fd, ids = answers[0]
    with uncounted():
        table = torch.from_numpy(x).to(dev)
        q_dev = torch.from_numpy(queries).to(dev)
        wd, ws = exact_search(q_dev, table, torch.from_numpy(live).to(dev),
                              K + 1)
        err = check_topk("sharded flat against the single-device f32 scan",
                         torch.from_numpy(fd.astype(np.float64) ** 2),
                         torch.from_numpy(ids), wd, ws, group=K,
                         scale=((q_dev * q_dev).sum(-1)
                                + (table * table).sum(-1).max()).cpu()
                         .numpy())
        del table
    same = ids == ws[:, :K].cpu().numpy()
    dist_err = float(np.abs(fd - np.sqrt(np.maximum(
        wd[:, :K].cpu().numpy(), 0)))[same].max())
    if dist_err > 1e-5:
        raise AssertionError(f"sharded flat: distance error {dist_err}")
    say(f"ShardedFlatIndex, {SH_SHARDS} shards of {cap} rows on one card: "
        f"{qps:.1f} QPS at B = {len(queries)}; ids equal to the "
        f"single-device f32 scan between apart values, distances within "
        f"{dist_err:.2e} (squares: max abs err {err}); the 2 x 2 mesh "
        "answers the same")
    return qps, answers[0]


def sharded_ivf(torch, say, mesh, x, live, queries, truth, batches):
    """Phase 7b, b: ShardedIVF (SH_IVF_CELLS cells, n_probe SH_IVF_PROBE):
    build, recall against the sharded f32 scan, and SH_CHECK_B answers
    equal to each shard's own answer merged on the host; the rows that the
    default max_list (twice the mean shard-cell) leaves out of the lists,
    and the recall of a rebuild whose max_list holds every row. Returns
    its numbers."""
    from vector_db_tpu_torch.index.ivf import _ivf_search_batch
    from vector_db_tpu_torch.parallel.sharded import ShardedIVF

    cap = SVC_N // SH_SHARDS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = ShardedIVF(mesh=mesh, dim=SVC_DIM, capacity_per_shard=cap,
                     k_cells=SH_IVF_CELLS)
    ivf.build(range(SVC_N), x)
    for i in np.nonzero(~live)[0]:
        ivf.delete(int(i))
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    got = ivf.search_batch(queries, K, n_probe=SH_IVF_PROBE)
    out["recall"] = recall_at(got[1], truth)
    out["qps"] = median_qps(torch, lambda q: ivf.search_batch(
        q, K, n_probe=SH_IVF_PROBE), batches)
    listed = sum(int((lst >= 0).sum()) for lst in ivf._lists)
    listed_live = sum(
        int(((lst >= 0) & ivf._valid[s][lst.clamp_min(0).long()]).sum())
        for s, lst in enumerate(ivf._lists))
    out.update(max_list=ivf.max_list, listed=listed, listed_live=listed_live,
               live=int(live.sum()), dropped=SVC_N - listed,
               largest_fill=int(ivf.cell_fill.max()))
    qc = torch.from_numpy(queries[:SH_CHECK_B]).to(mesh.devices[0])
    parts = [_ivf_search_batch(ivf._centroids[s], ivf._lists[s], ivf._emb[s],
                               ivf._valid[s], qc, None, SH_IVF_PROBE, K)
             for s in range(SH_SHARDS)]
    pd = np.concatenate([p[0].cpu().numpy() for p in parts], 1)
    pg = np.concatenate([np.where(p[1].cpu().numpy() >= 0,
                                  p[1].cpu().numpy() + s * cap, -1)
                         for s, p in enumerate(parts)], 1)
    order = np.argsort(pd, axis=1, kind="stable")[:, :K]
    md, mg = np.take_along_axis(pd, order, 1), np.take_along_axis(pg, order, 1)
    same_answer("ShardedIVF against its shards' own answers merged",
                ivf.search_batch(queries[:SH_CHECK_B], K,
                                 n_probe=SH_IVF_PROBE),
                (np.where(mg >= 0, np.sqrt(np.maximum(md, 0)),
                          np.inf).astype(np.float32),
                 np.where(mg >= 0, ivf._id_of_gslot[np.maximum(mg, 0)], -1)))
    del ivf
    full = ShardedIVF(mesh=mesh, dim=SVC_DIM, capacity_per_shard=cap,
                      k_cells=SH_IVF_CELLS, max_list=out["largest_fill"])
    full.build(range(SVC_N), x)
    for i in np.nonzero(~live)[0]:
        full.delete(int(i))
    if sum(int((lst >= 0).sum()) for lst in full._lists) != SVC_N:
        raise AssertionError("ShardedIVF at the largest fill: a row left "
                             "out of the lists")
    out["recall_all_listed"] = recall_at(full.search_batch(
        queries, K, n_probe=SH_IVF_PROBE)[1], truth)
    del full
    say(f"ShardedIVF ({SH_IVF_CELLS} cells, n_probe {SH_IVF_PROBE}): build "
        f"{out['build_s']:.2f} s, recall@{K} {out['recall']:.4f} against the "
        f"sharded f32 scan, {out['qps']:.1f} QPS; {SH_CHECK_B} answers equal "
        f"to each shard's own merged on the host; max_list "
        f"{out['max_list']} lists {out['listed']} of {SVC_N} rows "
        f"({out['listed_live']} of the {out['live']} live ones; "
        f"{out['dropped']} left out), the largest shard-cell was given "
        f"{out['largest_fill']}; rebuilt with max_list "
        f"{out['largest_fill']} (every row listed): recall@{K} "
        f"{out['recall_all_listed']:.4f}")
    return out


def sharded_hnsw_modes(torch, say, kernels, h, ref, queries, truths,
                       allowed, deleted):
    """Phase 7b, c: the sharded HNSW's searches at B = len(queries), each
    timed once (after a warm-up on 8 queries only where the call builds
    the wide mirrors) and held to phase 6's unsharded HNSW at the same
    settings (its calls uncounted): recall against each index's own f32 scan
    (``truths``: sharded, sharded filtered, unsharded, unsharded
    filtered), no sharded recall below the unsharded one less SH_SLACK;
    sorted_topk at the sharded wide merges against its plain version.
    Returns {mode: numbers}."""
    from vector_db_tpu_torch.index import wide_beam
    from vector_db_tpu_torch.ops.cuda.sorted_topk import (
        sorted_topk, sorted_topk_plain)

    wide = dict(ef=WIDE_EF, frontier=WIDE_F, steps=WIDE_T)
    modes = {f"classic_ef{ef}": (
        lambda q, ef=ef: h.search_batch(q, K, ef=ef),
        lambda q, ef=ef: ref.search_batch(q, K, ef=ef, bucket=False))
        for ef in SH_CLASSIC_EFS}
    modes.update({
        "filtered_ef50": (
            lambda q: h.search_batch(q, K, ef=50, filter_ids=allowed),
            lambda q: ref.search_batch(q, K, ef=50, filter_ids=allowed,
                                       bucket=False)),
        "wide": (lambda q: h.search_batch_wide(q, K, **wide),
                 lambda q: ref.search_batch_wide(q, K, bucket=False, **wide)),
        "wide_merge_kernel": (
            lambda q: h.search_batch_wide(q, K, merge_kernel=True, **wide),
            lambda q: ref.search_batch_wide(q, K, merge_kernel=True,
                                            bucket=False, **wide)),
        "beam": (lambda q: h.search_batch_beam(q, K, **SH_BEAM),
                 lambda q: ref.search_batch_beam(q, K, bucket=False,
                                                 **SH_BEAM)),
    })

    def timed(call, warm):
        if warm:
            call(queries[:8])               # the mirrors build
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ids = call(queries)
        torch.cuda.synchronize()
        return ids, len(queries) / (time.perf_counter() - t0)

    rows = {}
    for name, (call, unsharded) in modes.items():
        f = name.startswith("filtered")
        # the classic loop takes as many steps for 8 queries as for all,
        # and the beam reads the tables the wide rows built
        warm = name.startswith("wide")
        got, qps = timed(call, warm)
        if set(got.ravel().tolist()) & deleted:
            raise AssertionError(f"sharded {name}: a deleted id")
        if f and not set(got[got >= 0].tolist()) <= allowed:
            raise AssertionError(f"sharded {name}: outside the filter")
        with uncounted():
            ref_got, ref_qps = timed(unsharded, warm)
        rows[name] = {"recall": recall_at(got, truths[int(f)]), "qps": qps,
                      "unsharded_recall": recall_at(ref_got, truths[2 + f]),
                      "unsharded_qps": ref_qps}
        if rows[name]["recall"] < rows[name]["unsharded_recall"] - SH_SLACK:
            raise AssertionError(f"sharded {name}: {rows[name]}")
    with uncounted():
        calls = captured(wide_beam, "sorted_topk", lambda: h.search_batch_wide(
            queries, K, merge_kernel=True, **wide))
        err = 0.0
        for args, opts in calls:
            d, v, topk = args[:3]
            err = max(err, check_sorted(
                "sharded wide: sorted_topk", sorted_topk(*args, **opts),
                sorted_topk_plain(d, v, topk + 1)))
    fold_err(kernels, "sorted_topk", err)
    say(f"ShardedHNSW searches at B = {len(queries)}, recall@{K} against "
        f"the f32 scan of each index's rows, QPS of one timed call (host "
        f"clock), beside phase 6's unsharded HNSW at the same settings "
        f"(wide {wide}, beam {SH_BEAM}, ef and k unrounded): "
        + "; ".join(f"{n}: {r['recall']:.4f} at {r['qps']:.1f} QPS "
                    f"(unsharded {r['unsharded_recall']:.4f} at "
                    f"{r['unsharded_qps']:.1f})" for n, r in rows.items())
        + f"; floor: the unsharded recall less {SH_SLACK}; sorted_topk on "
        f"the sharded wide call's {len(calls)} merges against "
        f"sorted_topk_plain: max abs err {err}")
    return rows


def sharded_service(torch, say, x, queries, batches):
    """Phase 7b, d: the sharded-hnsw service at SVC_SMALL_N rows on every
    visible card (capacity SVC_SMALL_N), fed in batches of SVC_BATCH:
    equal to the direct index call, the single query to the batch's row,
    recall against the f32 scan, and the same answers after a restart.
    Returns its numbers."""
    import tempfile
    from pathlib import Path

    from vector_db_tpu_torch.ops.exact import exact_search
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.storage import InMemoryNodeStorage
    from vector_db_tpu_torch.types import Node

    nodes = [Node(id=i, embedding=x[i], metadata={"tag": i % SVC_TAGS})
             for i in range(SVC_SMALL_N)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = svc_config(tmp / "sharded.yaml", tmp / "sharded",
                         capacity=SVC_SMALL_N, type="sharded-hnsw")
        storage = InMemoryNodeStorage()
        svc = IndexingService(storage=storage, config_path=cfg,
                              index_file=str(tmp / "sharded.npz"))
        t0 = time.perf_counter()
        for s in range(0, SVC_SMALL_N, SVC_BATCH):
            svc.insert_nodes(nodes[s:s + SVC_BATCH])
        svc.wait_for_flush()
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        got = svc.search_batch(queries, K)
        single = [n.id for n, _ in svc.search(queries[0], k=K)]
        dev = svc.index.mesh.devices[0]
        with uncounted():
            same_answer("sharded-hnsw service", got,
                        svc.index.search_batch(queries, K, ef=50))
            _, slots = exact_search(
                torch.from_numpy(queries).to(dev),
                torch.from_numpy(x[:SVC_SMALL_N]).to(dev),
                torch.ones(SVC_SMALL_N, dtype=torch.bool, device=dev), K)
        if single != [int(v) for v in got[1][0] if v >= 0]:
            raise AssertionError("sharded-hnsw service: the single query "
                                 "differs from the batch's row")
        out = {"ingest_docs_s": SVC_SMALL_N / ingest_s,
               "qps": median_qps(torch, lambda q: svc.search_batch(q, K),
                                 batches),
               "recall": recall_at(got[1], slots.cpu().numpy()),
               "shards": svc.index.n_shards}
        svc.force_save_index()
        t0 = time.perf_counter()
        again = IndexingService(storage=storage, config_path=cfg,
                                index_file=str(tmp / "sharded.npz"))
        out["restart_s"] = time.perf_counter() - t0
        if not again.is_index_loaded() or again.get_index_size() != \
                SVC_SMALL_N:
            raise AssertionError("sharded-hnsw service: restart")
        same_answer("sharded-hnsw service after a restart",
                    again.search_batch(queries, K), got)
    say(f"sharded-hnsw service ({SVC_SMALL_N} x {SVC_DIM}, {out['shards']} "
        f"shard(s), one a visible card): ingest "
        f"{out['ingest_docs_s']:.1f} docs/s in batches of {SVC_BATCH} (each "
        f"past the threshold saves synchronously); {out['qps']:.1f} QPS at "
        f"B = {len(queries)} (ef 50), recall@{K} {out['recall']:.4f} "
        f"against the f32 scan; equal to the direct index call, the single "
        f"query to the batch's row; restart {out['restart_s']:.2f} s, the "
        "same answers after it")
    return out


def phase_sharding(torch, kernels, card, base):
    """Phase 7b: the sharded indexes at config.yaml's deployment, SH_SHARDS
    shards on the one card (``make_mesh(devices=[cuda:0] * 4)``, each a
    quarter of the rows): ShardedFlatIndex against the single-device f32
    scan and the 2 x 2 mesh against the 1-D one; ShardedIVF; ShardedHNSW
    through bulk_build, streamed inserts and deletes as the service's
    deployment feeds phase 6, its searches beside phase 6's unsharded
    HNSW on the same rows at the same settings, save and reload, profiles;
    then the sharded-hnsw service. ``base``: phase 6's index, rows,
    queries and deleted ids."""
    import tempfile
    from pathlib import Path

    from vector_db_tpu_torch.ops.exact import exact_search
    from vector_db_tpu_torch.parallel.mesh import make_mesh
    from vector_db_tpu_torch.parallel.sharded import ShardedHNSW

    def say(msg):  # with the seconds since the phase began
        log(f"{msg} (+{time.perf_counter() - t_phase:.1f} s) [{card}]")

    t_phase = time.perf_counter()
    x, queries, deleted, ref = (base["x"], base["queries"], base["deleted"],
                                base["index"])
    dev = ref.device
    mesh = make_mesh(devices=[dev] * SH_SHARDS)
    cap = SVC_N // SH_SHARDS
    live = np.ones(SVC_N, bool)
    live[sorted(deleted)] = False
    allowed = set(range(3, SVC_N, SVC_TAGS)) - deleted      # tag == 3
    rng = np.random.default_rng(9)
    batches = [queries + 0.01 * rng.standard_normal(queries.shape).astype(
        np.float32) for _ in range(5)]
    # the sharded path: counts at 0 just before it
    _reset_counts()
    out = {}
    out["flat_qps"], (_, truth) = sharded_flat(
        torch, say, kernels, mesh, x, queries, live, batches)
    with uncounted():
        _, fs = exact_search(
            torch.from_numpy(queries).to(dev), torch.from_numpy(x).to(dev),
            torch.from_numpy(live & (np.arange(SVC_N) % SVC_TAGS == 3)).to(
                dev), K)
        _, ref_truth = ref.search_batch_scan(queries, K, mode="exact")
        _, ref_ftruth = ref.search_batch_scan(queries, K, mode="exact",
                                              filter_ids=allowed)
    out["ivf"] = sharded_ivf(torch, say, mesh, x, live, queries, truth,
                             batches)
    gc.collect()
    torch.cuda.empty_cache()

    # the service streamed SVC_BATCHES batches; the sharded index streams
    # SH_BATCHES of them and bulk-builds the rows of the rest
    n_bulk = SVC_N - SH_BATCHES * SVC_BATCH - SVC_SINGLE
    h = ShardedHNSW(M=HNSW_M, ef_construction=HNSW_EFC, mesh=mesh,
                    dim=SVC_DIM, capacity_per_shard=cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h.bulk_build(range(n_bulk), x[:n_bulk])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    secs = []
    for s in range(n_bulk, SVC_N - SVC_SINGLE, SVC_BATCH):
        t0 = time.perf_counter()
        h.insert(range(s, s + SVC_BATCH), x[s:s + SVC_BATCH])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    h.insert(range(SVC_N - SVC_SINGLE, SVC_N), x[SVC_N - SVC_SINGLE:])
    t0 = time.perf_counter()
    h.delete_batch(sorted(deleted))
    torch.cuda.synchronize()
    delete_s = time.perf_counter() - t0
    if h.size != int(live.sum()):
        raise AssertionError(f"ShardedHNSW: size {h.size}")
    h.enable_wide(dims=120, seeds=SH_SEEDS)
    say(f"ShardedHNSW ({SH_SHARDS} shards of {cap}, M {HNSW_M}, "
        f"ef_construction {HNSW_EFC}): bulk_build of {n_bulk} rows "
        f"{build_s:.2f} s; {SH_BATCHES} inserts of {SVC_BATCH} "
        f"{SH_BATCHES * SVC_BATCH / sum(secs):.1f} docs/s (per batch "
        f"{[round(t, 2) for t in secs]} s), then {SVC_SINGLE} more; "
        f"delete_batch of {len(deleted)} {delete_s:.3f} s")
    out["hnsw"] = {"build_s": build_s, "delete_s": delete_s,
                   "insert_docs_s": SH_BATCHES * SVC_BATCH / sum(secs)}
    out["hnsw"]["modes"] = sharded_hnsw_modes(
        torch, say, kernels, h, ref, queries,
        (truth, fs.cpu().numpy(), ref_truth, ref_ftruth), allowed, deleted)
    # one call each: the classic call's ~8,000 small ops make the
    # profiler's own processing take tens of seconds a call
    profile(torch, f"sharded classic ef 50 ({SH_SHARDS} shards, B = "
            f"{len(queries)})", lambda: h.search_batch(queries, K, ef=50),
            reps=1)
    profile(torch, f"sharded wide, merge kernel ({SH_SHARDS} shards, B = "
            f"{len(queries)})", lambda: h.search_batch_wide(
                queries, K, ef=WIDE_EF, frontier=WIDE_F, steps=WIDE_T,
                merge_kernel=True), reps=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "sharded.npz"
        t0 = time.perf_counter()
        h.save_index(path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        h2 = ShardedHNSW(M=HNSW_M, ef_construction=HNSW_EFC,
                         mesh=make_mesh(devices=[dev] * SH_SHARDS),
                         dim=SVC_DIM, capacity_per_shard=cap)
        t0 = time.perf_counter()
        h2.load_index(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        with uncounted():
            same_answer("ShardedHNSW reload",
                        h2.search_batch(queries, K, ef=50),
                        h.search_batch(queries, K, ef=50))
        del h2
    counts = _counts()
    _launched("sharded", counts, ("l2_topk", "sorted_topk"))
    say(f"ShardedHNSW save_index {save_s:.2f} s ({nbytes} bytes), "
        f"load_index into a fresh {SH_SHARDS}-shard index {load_s:.2f} s, "
        f"the same ids and distances after it; launches of the sharded path "
        f"(checks and unsharded calls uncounted) {counts}")
    del h
    gc.collect()
    torch.cuda.empty_cache()
    out["service"] = sharded_service(torch, say, x, queries, batches)
    return out


def phase_bench(torch, kernels, card, dev):
    """Phase 8: the port's headline benchmark, ``bench_torch.run``, in this
    process: the HNSW detail at BENCH_HNSW_N and BENCH_REF_N x 384 rows,
    the reference from the committed cache, the headline scans at
    BENCH_HEADLINE_N x 768. Its JSON line is logged; the best mode is held
    to the bench's target, each per-call row to phase 3's floor for its
    mode, and each of the bench's four kernels must have launched."""
    import io
    import tempfile
    from pathlib import Path

    import bench_torch

    t0 = time.perf_counter()
    _reset_counts()
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(out):
        details = bench_torch.run(
            hnsw_n=BENCH_HNSW_N, headline_n=BENCH_HEADLINE_N,
            ref_n=BENCH_REF_N, n_q=BENCH_QUERIES, device=dev,
            cache_path=Path(__file__).resolve().parent / ".bench_ref.json",
            details_path=Path(tmp) / "details.json")
    counts = _counts()
    lines = out.getvalue().strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench_torch printed {len(lines)} lines")
    line = json.loads(lines[0])
    log(f"phase 8 bench_torch result (headline cut to {BENCH_HEADLINE_N:,} "
        f"of 1,000,000 rows) [{card}]: {lines[0]}")
    if set(line) != {"metric", "value", "unit", "vs_baseline"}:
        raise AssertionError(f"bench_torch line keys {sorted(line)}")
    head = details["headline_1M_768"]
    best = head[details["best_mode"]]
    if best["recall"] < BENCH_TARGET or line["value"] <= 0:
        raise AssertionError(f"best mode {details['best_mode']}: {best}")
    for mode, floor in BENCH_FLOORS.items():
        if head[mode]["recall"] < floor:
            raise AssertionError(f"bench {mode}: recall {head[mode]} < "
                                 f"{floor}")
        if head[f"{mode}_sustained"]["qps"] <= 0:
            raise AssertionError(f"bench {mode}: no sustained row")
    _launched("bench", counts, ("l2_topk", "l2_topk_bf16", "block_min",
                                "block_topm"))
    for name in ("l2_topk", "l2_topk_bf16", "block_min", "block_topm"):
        kernels[name]["launches"] += counts[name]
    log(f"phase 8 rows [{card}]: " + json.dumps(
        {m: {"qps": round(r["qps"], 1), "recall": r["recall"]}
         for m, r in head.items() if isinstance(r, dict) and "qps" in r}))
    log(f"phase 8 host syncs in one call of each mode: "
        f"{head['host_syncs']}")
    log(f"phase 8 HNSW detail: {details['ours_hnsw_detail']['ef']} / "
        f"{details['ours_matched']['ef']} ef at {BENCH_HNSW_N:,} / "
        f"{BENCH_REF_N:,} rows; vs_baseline {line['vs_baseline']}; launches "
        f"of the bench {counts}")
    log(f"phase 8 ok on {card} ({time.perf_counter() - t0:.1f} s)")


def _scripts(names=("bench_10m_torch", "dryrun_sharded_10m_torch")):
    """The port's scripts under scripts/ (by default the 10M ones),
    imported from the checkout."""
    import importlib
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    return [importlib.import_module(name) for name in names]


def _run_script(module, n, dev, out_name, **kwargs):
    """``module.run(n, dev, ..., **kwargs)`` with its JSON file in a
    temporary directory and its one stdout line captured: (results, the
    line)."""
    import io
    import tempfile
    from pathlib import Path

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(out):
        res = module.run(n, dev, Path(tmp) / out_name, **kwargs)
    lines = out.getvalue().strip().splitlines()
    if len(lines) != 1 or json.loads(lines[0]) != json.loads(
            json.dumps(res)):
        raise AssertionError(f"{module.__name__} printed {len(lines)} lines "
                             "or a line other than its results")
    return res, lines[0]


def ten_m_one_card(torch, card, dev, one, err):
    """Phase 9, one card: ``bench_10m_torch.run`` at TEN_M_N rows, its
    recalls held to their floors; then, on its own tables (kept from the
    run), a profile of the routed search, block_min against its plain
    version at ds = 120 (TEN_M_CHECK_B queries under the filter's norms,
    and all B queries in slices) with its time, and l2_topk against its
    plain version at one chunk under the filter's mask with its time.
    Returns the path's launch counts and the kernels' timings."""
    from vector_db_tpu_torch.ops.cuda.block_min import (
        block_min_plain, block_min_scan)
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk, l2_topk_plain

    kept = {}
    real_build = one.build_tables

    def build_and_keep(queries, proj, *args, **kwargs):
        kept.update(tab=real_build(queries, proj, *args, **kwargs),
                    queries=queries, proj=proj)
        return kept["tab"]

    _reset_counts()
    one.build_tables = build_and_keep
    try:
        res, line = _run_script(one, TEN_M_N, dev, "BENCH_10M_TORCH.json")
    finally:
        one.build_tables = real_build
    counts = _counts()
    log(f"phase 9 bench_10m_torch result [{card}]: {line}")
    for op in res["ops"]:
        floor = TEN_M_JAX[op["blocks_k"]] - TEN_M_SLACK
        if op["recall"] < floor:
            raise AssertionError(f"10M blocks_k {op['blocks_k']}: recall "
                                 f"{op['recall']} < {floor}")
    routed, filt = res["routed"], res["filtered_10pct"]
    if routed["holdout_recall"] < TEN_M_ROUTED_FLOOR:
        raise AssertionError(f"10M routed: {routed}")
    if filt["recall"] < TEN_M_FILTERED_JAX - TEN_M_SLACK:
        raise AssertionError(f"10M filtered: {filt}")
    _launched("10M one-card", counts, ("l2_topk", "block_min"))
    ladder = [(o["blocks_k"], o["recall"], round(o["qps"], 1))
              for o in res["ops"]]
    log(f"phase 9 one card: (blocks_k, recall, QPS) {ladder}, routed "
        f"{routed}, filtered {filt}, launches {counts}")

    tab, q, proj = kept["tab"], kept["queries"], kept["proj"]
    qm = q @ proj
    c = routed["blocks_k"]
    profile(torch, f"phase 9 routed search (blocks_k {c}, B {q.shape[0]}, "
            f"{TEN_M_N:,} rows) [{card}]", lambda: one.search(tab, q, qm, c))

    # block_min at the ds = 120 mirror: TEN_M_CHECK_B queries under the
    # filter's norms, then every query in slices (the [B, N / 128] output)
    xf = one.filtered_norms(tab)
    qs = qm[:TEN_M_CHECK_B].contiguous()
    e = check_topk("block_min ds 120, filtered",
                   block_min_scan(qs, tab.mirror, xf), None,
                   block_min_plain(qs, tab.mirror, xf), None, group=1,
                   scale=block_terms(qs, tab.mirror, xf))
    del xf
    got = block_min_scan(qm, tab.mirror, tab.xsq_eff)
    nb = got.shape[1]
    scale = block_terms(qm, tab.mirror, tab.xsq_eff)
    for s0 in range(0, q.shape[0], TEN_M_SLICE):
        qv = qm[s0:s0 + TEN_M_SLICE].contiguous()
        e = max(e, check_topk(
            f"block_min ds 120, queries {s0}+", got[s0:s0 + TEN_M_SLICE],
            None, block_min_plain(qv, tab.mirror, tab.xsq_eff), None,
            group=1, scale=scale[s0 * nb:(s0 + qv.shape[0]) * nb]))
    del got, scale
    err["block_min"] = e
    ms = cuda_ms(torch, lambda: block_min_scan(qm, tab.mirror, tab.xsq_eff))
    plain_ms = cuda_ms(torch, lambda: block_min_plain(qm, tab.mirror,
                                                      tab.xsq_eff))
    n_pad, dp = tab.mirror.shape
    b = q.shape[0]
    bm = {"ms": ms, "plain_ms": plain_ms}
    set_bound(bm, n_pad * (dp * 2 + 4) + b * dp * 4 + b * nb * 4,
              2.0 * b * n_pad * dp, BF16_TC_FLOPS)
    log(f"phase 9 block_min bf16 table N={n_pad} ds={dp} B={b} [{card}]: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bm['bound_ms']:.3f} ms ({bm['bound_by']}), max abs err {e} "
        f"(filtered at B={TEN_M_CHECK_B} and every query)")
    del tab
    kept.clear()

    # l2_topk at one chunk of the truth's fold, under the filter's mask
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.nn.functional.normalize(
        torch.randn(one.CHUNK, one.DIM, generator=gen, device=dev), dim=1)
    x_sq = (x * x).sum(-1)
    valid = torch.arange(one.CHUNK, device=dev) % one.FILTER_EVERY == 0
    got = l2_topk(q, x, valid, one.K, x_sq=x_sq)
    want = l2_topk_plain(q, x, valid, one.K + 1, x_sq)
    err["l2_topk"] = check_topk("l2_topk phase 9 chunk, filtered", *got,
                                *want, group=one.K, scale=terms(q, x_sq))
    ms = cuda_ms(torch, lambda: l2_topk(q, x, valid, one.K, x_sq=x_sq))
    plain_ms = cuda_ms(torch, lambda: l2_topk_plain(q, x, valid, one.K,
                                                    x_sq))
    lt = {"ms": ms, "plain_ms": plain_ms}
    set_bound(lt, one.CHUNK * (one.DIM * 4 + 5) + b * one.DIM * 4
              + b * one.K * 8, 3.0 * 2.0 * b * one.CHUNK * one.DIM,
              TF32_TC_FLOPS)
    log(f"phase 9 l2_topk f32 chunk N={one.CHUNK} d={one.DIM} B={b} "
        f"k={one.K} [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {lt['bound_ms']:.3f} ms ({lt['bound_by']}), max abs err "
        f"{err['l2_topk']}")
    return counts, {"block_min": bm, "l2_topk": lt}


def ten_m_sharded(torch, card, dev, sh, err):
    """Phase 9, sharded: ``dryrun_sharded_10m_torch.run`` at TEN_M_N rows
    over 8 shards, its recall held to its floor (the run itself raises
    unless its merge equals a plain stable merge); then, on its shards (kept from the run), a profile of one sharded
    search and block_min's f32 path against its plain version on shard 0.
    Returns the path's launch counts."""
    from vector_db_tpu_torch.ops.cuda.block_min import (
        block_min_plain, block_min_scan)

    kept = {}
    real_shards = sh.build_shards

    def shards_and_keep(*args):
        kept.update(shards=real_shards(*args), args=args)
        return kept["shards"]

    _reset_counts()
    sh.build_shards = shards_and_keep
    try:
        res, line = _run_script(sh, TEN_M_N, dev,
                                "BENCH_SHARDED_10M_TORCH.json")
    finally:
        sh.build_shards = real_shards
    counts = _counts()
    log(f"phase 9 dryrun_sharded_10m_torch result [{card}]: {line}")
    floor = TEN_M_SHARDED_JAX - TEN_M_SLACK
    if res["recall_at_10"] < floor:
        raise AssertionError(f"10M sharded: recall {res['recall_at_10']} "
                             f"< {floor}")
    _launched("10M sharded", counts, ("l2_topk", "block_min"))

    shards = kept["shards"]
    _, mesh, queries, proj, _ = kept["args"]
    qm = queries @ proj
    profile(torch, f"phase 9 sharded search ({len(shards)} shards, B "
            f"{queries.shape[0]}) [{card}]",
            lambda: sh.search_sharded(shards, mesh, queries, qm,
                                      sh.BLOCKS_K))
    s0 = shards[0]
    e = check_topk("block_min f32 shard 0",
                   block_min_scan(qm, s0.mirror, s0.xsq_eff), None,
                   block_min_plain(qm, s0.mirror, s0.xsq_eff), None,
                   group=1, scale=block_terms(qm, s0.mirror, s0.xsq_eff))
    err["block_min"] = max(err["block_min"], e)
    ms = cuda_ms(torch, lambda: block_min_scan(qm, s0.mirror, s0.xsq_eff))
    n_pad, dp = s0.mirror.shape
    b = queries.shape[0]
    nbytes = n_pad * (dp * 4 + 4) + b * dp * 4 + b * (n_pad // 128) * 4
    t_bound, by = bound(nbytes, 2.0 * b * n_pad * dp, F32_FLOPS)
    log(f"phase 9 block_min f32 table (shard 0) N={n_pad} ds={dp} B={b} "
        f"[{card}]: kernel {ms:.3f} ms, bound {t_bound:.3f} ms ({by}), "
        f"max abs err {e}; recall {res['recall_at_10']}, launches {counts}")
    kept.clear()
    return counts


def phase_10m(torch, kernels, card, dev):
    """Phase 9: the 10M x 768 configuration (scripts/bench_10m_torch.py)
    and its sharded form (scripts/dryrun_sharded_10m_torch.py), each run
    in this process at TEN_M_N rows and its tables freed before the next.
    The phase's kernels, block_min and l2_topk, get records of their own
    (``block_min_10m``, ``l2_topk_10m``): both scripts' launches, the
    kernels held against their plain versions, and their times at the
    one-card shapes."""
    t0 = time.perf_counter()
    one, sh = _scripts()
    err = {}
    counts, timed = ten_m_one_card(torch, card, dev, one, err)
    gc.collect()
    torch.cuda.empty_cache()
    more = ten_m_sharded(torch, card, dev, sh, err)
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("block_min", "l2_topk"):
        kernels[f"{name}_10m"].update(
            launches=counts[name] + more[name], max_abs_err=err[name],
            **timed[name])
    log(f"phase 9 ok on {card} ({time.perf_counter() - t0:.1f} s)")


# the keys that name a row of a list (not its measurements)
_ROW_METRICS = {"recall", "qps", "device_ms", "launches", "port_adc",
                "ms_per_batch", "device_ms_est"}


def _leaves(res, path=""):
    """(row name, key, value) of every entry of a benchmark's JSON: a
    dict's entries under its path, a list's dicts under the path and their
    naming keys (``ivf_rp[fetch=128,n_probe=8]``)."""
    if isinstance(res, dict):
        for key, val in res.items():
            yield path, key, val
            if isinstance(val, (dict, list)) and not key.endswith(
                    "launches"):
                yield from _leaves(val, f"{path}.{key}".strip("."))
    elif isinstance(res, list):
        for row in res:
            if isinstance(row, dict):
                ident = ",".join(f"{k}={row[k]}" for k in sorted(row)
                                 if k not in _ROW_METRICS and isinstance(
                                     row[k], (str, int, float, bool)))
                yield from _leaves(row, f"{path}[{ident}]")


def recall_rows(res) -> dict:
    """{row name: recall} of a benchmark's JSON (``recall``,
    ``set_recall_at_100``, ``*_recall_at_100``)."""
    return {(path if key == "recall" else f"{path}.{key}".strip(".")):
            float(val) for path, key, val in _leaves(res)
            if key == "recall" or key.endswith("recall_at_100")}


def _row_launches(res) -> dict:
    """{row name: its ``launches`` record}, named as recall_rows names."""
    return {(path if key == "launches" else f"{path}.{key}".strip(".")): val
            for path, key, val in _leaves(res) if key.endswith("launches")}


def _p10_kernels(script: str, name: str) -> tuple:
    """The kernels a phase 10 row must launch (by the row's name)."""
    if script == "bench_pq_torch":
        return ("adc_topk",)
    if name == "build_launches":        # knn_exact in the HNSW build
        return ("l2_topk",)
    if name.endswith("exact_f32") or "engine=scan_exact" in name:
        return ("l2_topk",)
    if name.endswith("bf16_scan") or "mode=bf16_scan" in name or \
            "engine=scan," in name:
        return ("l2_topk_bf16",)
    if name.endswith("blocksel_3p") or "mode=blocksel_3p" in name:
        return ("block_min",)
    if name.endswith("blocksel_2p"):
        return ("block_topm",)
    if name.startswith("pq_adc_scan"):
        return ("adc_topk",)
    if name.startswith("ivf_pq_residual"):
        if f"n_probe={P10_IVF_K}" in name:
            return ("adc_topk",)
        return () if "adc=gather" in name else ("adc_probe",)
    return ()


def p10_hold(script: str, res: dict, jax: dict) -> dict:
    """A script's rows against the JAX package's: every JAX row with a
    recall is in the port's file, each at or above the JAX reading less
    P10_SLACK (1.0 where the row is lossless by construction), and each
    row launched the kernels it must, the wide rows no sorted_topk.
    Returns {row: (port, JAX)}."""
    got, want = recall_rows(res), recall_rows(jax)
    missing = sorted(set(want) - set(got))
    if missing:
        raise AssertionError(f"{script}: JAX rows missing: {missing}")
    lossless = ("exact_f32", "blocksel_exact")
    pairs = {}
    for name, w in want.items():
        exact = name in lossless or name.endswith("mode=exact_f32")
        floor = 1.0 if exact else w - P10_SLACK
        if got[name] < floor:
            raise AssertionError(f"{script} {name}: recall {got[name]} < "
                                 f"{floor} (JAX {w})")
        pairs[name] = (got[name], w)
    for name, launched in _row_launches(res).items():
        need = _p10_kernels(script, name)
        for k in need:
            if launched.get(k, 0) <= 0:
                raise AssertionError(f"{script} {name}: {k} not launched "
                                     f"({launched})")
        if "wide" in name and launched.get("sorted_topk"):
            raise AssertionError(f"{script} {name}: sorted_topk launched "
                                 "with merge_kernel=False")
    return pairs


def _p10_jax(root) -> dict:
    """The JAX package's readings, by port script: the committed
    BENCH_*.json."""
    return {m: json.loads((root / f).read_text())
            for m, f in zip(P10_SCRIPTS, P10_JAX)}


def _p10_corpus(name, make):
    """Phase 4's or 5's corpus when it has this phase's shape, else
    ``make()``."""
    x, q = _SHARED.get(name) or (None, None)
    if x is None or x.shape[0] != P10_N:
        x, q = make()
    return x, q


def p10_kernel_checks(torch, kernels, card, ivf, codes_seen, queries):
    """The new shapes of phase 10 against their plain versions, timed:
    l2_topk f32 at k 100 over the SIFT table, block_min over its raw bf16
    copy, adc_topk at k 100 and 400 over the 1M x 16 codes."""
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk, adc_topk_plain
    from vector_db_tpu_torch.ops.cuda.block_min import (
        block_min_plain, block_min_scan)
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk, l2_topk_plain
    from vector_db_tpu_torch.ops.distance import PAD_ROW

    emb, has = ivf._emb, ivf._has_emb
    q = torch.from_numpy(queries).to(emb.device)
    n, d = emb.shape
    b, k = q.shape[0], 100
    x_sq = (emb * emb).sum(-1)
    e = check_topk("l2_topk f32 k 100 (SIFT table)",
                   *l2_topk(q, emb, has, k, x_sq=x_sq),
                   *l2_topk_plain(q, emb, has, k + 1, x_sq), group=k,
                   scale=terms(q, x_sq))
    rec = kernels["l2_topk_p10"]
    rec.update(max_abs_err=e,
               ms=cuda_ms(torch, lambda: l2_topk(q, emb, has, k, x_sq=x_sq)),
               plain_ms=cuda_ms(torch, lambda: l2_topk_plain(q, emb, has, k,
                                                             x_sq)))
    set_bound(rec, n * (d * 4 + 5) + b * d * 4 + b * k * 8,
              3.0 * 2.0 * b * n * d, TF32_TC_FLOPS)
    log(f"phase 10 l2_topk f32 N={n} d={d} B={b} k={k} [{card}]: kernel "
        f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), max abs err {e}")

    tab = emb.to(torch.bfloat16)
    xsq = torch.where(has, x_sq, PAD_ROW)
    e = check_topk("block_min bf16 SIFT table", block_min_scan(q, tab, xsq),
                   None, block_min_plain(q, tab, xsq), None, group=1,
                   scale=block_terms(q, tab, xsq))
    rec = kernels["block_min_p10"]
    rec.update(max_abs_err=e,
               ms=cuda_ms(torch, lambda: block_min_scan(q, tab, xsq)),
               plain_ms=cuda_ms(torch, lambda: block_min_plain(q, tab, xsq)))
    set_bound(rec, n * (d * 2 + 4) + b * d * 4 + b * (n // 128) * 4,
              2.0 * b * n * d, BF16_TC_FLOPS)
    log(f"phase 10 block_min bf16 SIFT table N={n} ds={d} B={b} [{card}]: "
        f"kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), max abs err {e}")
    del tab, xsq, x_sq

    for kk in (100, 400):
        lut, codes, valid = codes_seen[kk]
        bq, m, ksub = lut.shape
        nc = codes.shape[0]
        e = check_topk(f"adc_topk k {kk} (bench_pq)",
                       *adc_topk(lut, codes, valid, kk),
                       *adc_topk_plain(lut, codes, valid, kk + 1), group=kk,
                       scale=lut.amax(-1).sum(-1).cpu().numpy())
        rec = kernels[f"adc_topk_p10_k{kk}"]
        rec.update(max_abs_err=e,
                   ms=cuda_ms(torch, lambda: adc_topk(lut, codes, valid,
                                                      kk)),
                   plain_ms=cuda_ms(torch, lambda: adc_topk_plain(
                       lut, codes, valid, kk), reps=1))
        set_bound(rec, nc * (m * codes.element_size() + 1)
                  + bq * m * ksub * 4 + bq * kk * 8, float(bq) * nc * m,
                  F32_FLOPS)
        log(f"phase 10 adc_topk {codes.dtype} codes N={nc} m={m} "
            f"ksub={ksub} B={bq} k={kk} [{card}]: kernel {rec['ms']:.3f} "
            f"ms, plain {rec['plain_ms']:.3f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), max abs err {e}")


def phase_bench_scripts(torch, kernels, card, dev):
    """Phase 10: the benchmark scripts of BASELINE configs 3 and 4
    (scripts/bench_{sift,pq,1m,latency}_torch.py) at P10_N rows in this
    process, on phase 4's SIFT corpus and phase 5's 1M x 768 corpus; the
    latency benchmark on the SIFT script's spill-2 index and the 1M
    script's HNSW. Each script's line is logged, its rows held to the JAX
    package's readings (the committed BENCH_*.json) less P10_SLACK and to
    the kernels they must launch; the new shapes are held against their
    plain versions and timed."""
    from pathlib import Path

    from vector_db_tpu_torch.datasets import embedding_like, sift_like

    t0 = time.perf_counter()
    sift_s, pq_s, m1_s, lat_s = _scripts(P10_SCRIPTS)
    jax = _p10_jax(Path(__file__).resolve().parent)
    x, q = _p10_corpus("sift", lambda: sift_like(P10_N, dim=128, seed=0,
                                                 queries=1000))
    counts, seconds, held = {}, {}, {}

    def one(module, out_name, **kw):
        t1 = time.perf_counter()
        _reset_counts()
        res, line = _run_script(module, P10_N, dev, out_name, **kw)
        name = module.__name__
        counts[name] = _counts()
        seconds[name] = time.perf_counter() - t1
        log(f"phase 10 {name} result [{card}]: {line}")
        held[name] = p10_hold(name, res, jax[name])
        log(f"phase 10 {name}: {len(held[name])} rows held to the JAX "
            f"readings less {P10_SLACK} (port, JAX): {held[name]}; "
            f"launches {counts[name]} ({seconds[name]:.1f} s)")
        return res

    keep_sift = {}
    sift_res = one(sift_s, "BENCH_SIFT_TORCH.json", source={"x": x, "q": q},
                   k_cells=P10_IVF_K, keep=keep_sift)
    seen = {}
    real = pq_s.adc_topk_long

    def first_per_k(lut, codes, valid, k, **kw):
        seen.setdefault(k, (lut, codes, valid))
        return real(lut, codes, valid, k, **kw)

    pq_s.adc_topk_long = first_per_k
    try:
        pq_res = one(pq_s, "BENCH_PQ_TORCH.json", source={"x": x, "q": q})
    finally:
        pq_s.adc_topk_long = real
    p10_kernel_checks(torch, kernels, card, keep_sift["ivf"], seen, q)
    seen.clear()
    del x
    gc.collect()
    torch.cuda.empty_cache()

    def emb768():
        data = embedding_like(P10_N + 1000, 768, 0)
        return data[:P10_N], data[P10_N:]

    xg, qg = _p10_corpus("emb768", emb768)
    keep_1m = {}
    m1_res = one(m1_s, "BENCH_1M_TORCH.json",
                 source={"x": xg, "q": qg[:P10_B]}, b=P10_B,
                 k_cells=P10_IVF_K, keep=keep_1m)
    del xg
    gc.collect()
    torch.cuda.empty_cache()
    one(lat_s, "BENCH_LATENCY_TORCH.json",
        sift={"ivf": keep_sift["ivf"], "q": q[:P10_SIFT_Q]}, graph=keep_1m)
    keep_sift.clear()
    keep_1m.clear()
    gc.collect()
    torch.cuda.empty_cache()

    total = {k: sum(c[k] for c in counts.values()) for k in _counts()}
    k100 = sum(pq_res[c]["adc_launches"].get("adc_topk", 0)
               for c in ("pq", "opq"))
    k400 = sum(pq_res[c]["rerank_launches"].get("adc_topk", 0)
               for c in ("pq", "opq"))
    kernels["l2_topk_p10"]["launches"] = total["l2_topk"]
    kernels["block_min_p10"]["launches"] = total["block_min"]
    scan_k100 = sift_res["pq_adc_scan"]["launches"].get("adc_topk", 0)
    kernels["adc_topk_p10_k100"]["launches"] = k100 + scan_k100
    kernels["adc_topk_p10_k400"]["launches"] = k400
    # the IVF-PQ full scan's (k = fetch, row and group terms)
    kernels["adc_topk"]["launches"] += total["adc_topk"] - k100 - k400 \
        - scan_k100
    for name in ("l2_topk_bf16", "block_topm", "adc_probe"):
        kernels[name]["launches"] += total[name]
    _launched("phase 10", total, ("l2_topk", "l2_topk_bf16", "block_min",
                                  "block_topm", "adc_probe", "adc_topk"))
    if total["sorted_topk"]:
        raise AssertionError("phase 10: sorted_topk launched")
    log(f"phase 10 build_s {m1_res['build_s']:.1f} s (1M x 768, fresh); "
        f"seconds per script {seconds}; launches {total}")
    log(f"phase 10 ok on {card} ({time.perf_counter() - t0:.1f} s)")



def _p11_jax(root) -> dict:
    """The JAX package's readings, by port script: the committed
    BENCH_*.json."""
    return {m: json.loads((root / f).read_text())
            for m, f in zip(P11_SCRIPTS, P11_JAX)}


def p11_hold(script: str, res: dict, jax: dict) -> dict:
    """A script's results against the JAX package's file: every key of the
    JAX file is in the port's (named as ``_leaves`` names it), and each
    recall is at or above the JAX reading less P11_SLACK (the sharded flat
    index's at 1.0: it is the f32 exact scan). Returns {row: (port,
    JAX)}."""
    got = {(path, key): val for path, key, val in _leaves(res)}
    missing = sorted(f"{path}.{key}".strip(".") for path, key, _ in
                     _leaves(jax) if (path, key) not in got)
    if missing:
        raise AssertionError(f"{script}: JAX keys missing: {missing}")
    pairs = {}
    for path, key, want in _leaves(jax):
        if "recall" not in key or not isinstance(want, float):
            continue
        name = f"{path}.{key}".strip(".")
        floor = 1.0 if key == "recall_vs_bruteforce" else want - P11_SLACK
        if got[(path, key)] < floor:
            raise AssertionError(f"{script} {name}: recall "
                                 f"{got[(path, key)]} < {floor} (JAX {want})")
        pairs[name] = (got[(path, key)], want)
    return pairs


# the kernels a phase 11 row must launch, by script and row name (the
# bench_insert rows each launch l2_topk)
P11_NEED = {
    "bench_tiered_torch": {"ingest": ("l2_topk",),
                           "truth_launches": ("l2_topk",),
                           "bf16_scan": ("l2_topk_bf16",)},
    "bench_sharded_torch": {"flat_4m.search_launches": ("l2_topk",),
                            "hnsw_256k.build_launches": ("l2_topk",)},
    "bench_api_torch": {"ingest": ("l2_topk",),
                        "search_filtered_launches": ("l2_topk_bf16",)},
}


def p11_row_kernels(script: str, res: dict) -> dict:
    """Each row's launches hold the kernels its path must launch, and no
    row launches sorted_topk: the wide routes merge in plain torch, as the
    JAX configs ask (no ``merge_kernel``). Returns the rows' launches."""
    rows = _row_launches(res)
    need = P11_NEED.get(script, {})
    for name in need:
        if name not in rows:
            raise AssertionError(f"{script}: no launches recorded for {name}")
    for name, launched in rows.items():
        want = ("l2_topk",) if script == "bench_insert_torch" else \
            need.get(name, ())
        for k in want:
            if launched.get(k, 0) <= 0:
                raise AssertionError(f"{script} {name}: {k} not launched "
                                     f"({launched})")
        if launched.get("sorted_topk"):
            raise AssertionError(f"{script} {name}: sorted_topk launched")
    return rows


def p11_time(torch, kernels, name, card, label, q, tab, valid, k, x_sq,
             err) -> None:
    """Record ``name``: l2_topk at these inputs (held already, max abs err
    ``err``), its time, its plain version's and its bound; torch.matmul of
    the product is logged beside. The bound counts the valid rows only,
    the rows the answer needs; the padded share is logged beside it."""
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk, l2_topk_plain

    rows, d = tab.shape
    n = int(valid.sum())
    b = q.shape[0]
    rec = kernels[name]
    rec.update(max_abs_err=err,
               ms=cuda_ms(torch, lambda: l2_topk(q, tab, valid, k,
                                                 x_sq=x_sq)),
               plain_ms=cuda_ms(torch, lambda: l2_topk_plain(q, tab, valid,
                                                             k, x_sq)))
    bf16 = tab.dtype == torch.bfloat16
    set_bound(rec, n * (d * tab.element_size() + 5) + b * d * 4 + b * k * 8,
              (1.0 if bf16 else 3.0) * 2.0 * b * n * d,
              BF16_TC_FLOPS if bf16 else TF32_TC_FLOPS)
    qm = q.to(tab.dtype)
    mm = cuda_ms(torch, lambda: torch.matmul(qm, tab.T))
    log(f"phase 11 {label}: l2_topk {tab.dtype} N={n} valid of {rows} rows "
        f"({1 - n / rows:.1%} padding) d={d} B={b} k={k} [{card}]: kernel "
        f"{rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, torch.matmul "
        f"of the product {mm:.3f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}, valid rows), max abs err {err}")


def p11_insert(torch, kernels, card, dev, one):
    """bench_insert_torch at P11_INSERT_BASE: corpus_after exact, the
    streamed rows checked in the graph (a sample of P11_SELF_CHECK across
    both commit modes their own top-1), the level-0 candidate scan held at
    B 1024 and 4096 and timed, each record with the launches of the rows
    at its batch size."""
    from vector_db_tpu_torch.ops.distance import squared_norms

    keep = {}
    res = one("bench_insert_torch", P11_INSERT_BASE, "BENCH_INSERT_TORCH.json",
              keep=keep)
    mod = sys.modules["bench_insert_torch"]
    idx, x, base = keep["hnsw"], keep["x"], keep["base"]
    end = base + 2 * len(mod.MODES) * sum(mod.BATCHES) + len(mod.MODES)
    if res["corpus_after"] != end or idx.size != end:
        raise AssertionError(f"bench_insert: corpus_after "
                             f"{res['corpus_after']}, not {end}")
    sample = np.linspace(base, end - 1, P11_SELF_CHECK).astype(np.int64)
    check_inserted(torch, idx, x, base, end, sample,
                   say=lambda m: log(f"phase 11 bench_insert {m}"))
    emb = idx._emb
    valid = idx._has_emb & (idx.graph.levels >= 0)
    x_sq = squared_norms(emb)
    rows = _row_launches(res)
    for bs in mod.BATCHES:
        err = insert_scan_check(torch, idx, x[base:base + bs],
                                say=lambda m: log(f"phase 11 {m}"))
        q = torch.from_numpy(np.ascontiguousarray(x[base:base + bs])).to(dev)
        name = f"l2_topk_p11_b{bs}"
        p11_time(torch, kernels, name, card, f"bench_insert level-0 scan "
                 f"(B {bs})", q, emb, valid, HNSW_EFC, x_sq, err)
        kernels[name]["launches"] = sum(
            r.get("l2_topk", 0) for n, r in rows.items()
            if f"_batch_{bs}_" in n)
    keep.clear()


def p11_tiered(torch, kernels, card, one):
    """bench_tiered_torch at P11_TIERED_N: a flush per batch, the restart's
    facts, the bf16 scan row's l2_topk held at its inputs and timed, its
    record with that row's launches."""
    from vector_db_tpu_torch.ops import exact

    keep = {}
    res = one("bench_tiered_torch", P11_TIERED_N, "BENCH_TIERED_TORCH.json",
              keep=keep)
    mod = sys.modules["bench_tiered_torch"]
    batches = math.ceil(P11_TIERED_N / mod.BATCH)
    svc = keep["svc"]
    if res["ingest"]["flushes"] != batches:
        raise AssertionError(f"bench_tiered: {res['ingest']['flushes']} "
                             f"flushes, not {batches}")
    if not (res["resume"]["index_loaded"] and svc.is_index_loaded()
            and res["resume"]["storage_size"] == P11_TIERED_N
            and svc.get_index_size() == P11_TIERED_N):
        raise AssertionError(f"bench_tiered restart: {res['resume']}, index "
                             f"{svc.get_index_size()}")
    q = keep["q"]
    index = svc.index
    seen = captured(exact, "l2_topk", lambda: index.search_batch_scan(
        q, K, mode="bf16"))
    err = check_l2_calls(
        torch, lambda m: log(f"phase 11 {m}"), "bench_tiered bf16_scan",
        lambda: index.search_batch_scan(q, K, mode="bf16"), torch.bfloat16)
    (qd, tab, valid, k), opts = seen[0]
    p11_time(torch, kernels, "l2_topk_bf16_p11", card,
             "bench_tiered bf16_scan", qd, tab, valid, k, opts["x_sq"], err)
    kernels["l2_topk_bf16_p11"]["launches"] = \
        res["bf16_scan"]["launches"]["l2_topk_bf16"]
    keep.clear()


def p11_sharded(torch, kernels, card, one):
    """bench_sharded_torch at P11_SHARDED_N and P11_SHARDED_HNSW rows over 8
    shards: a search launches l2_topk once a shard; the kernel held at one
    shard's inputs and timed, its record with the searches' launches (the
    warm-up and the timed one, each counted by the script)."""
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk, l2_topk_plain

    keep = {}
    res = one("bench_sharded_torch", P11_SHARDED_N,
              "BENCH_SHARDED_TORCH.json", n_hnsw=P11_SHARDED_HNSW, keep=keep)
    shards = sys.modules["bench_sharded_torch"].SHARDS
    searches = [res["flat_4m"][key].get("l2_topk", 0)
                for key in ("warm_launches", "search_launches")]
    if res["mesh_devices"] != shards or searches != [shards, shards]:
        raise AssertionError(f"bench_sharded: {res['mesh_devices']} shards, "
                             f"{searches} l2_topk launches in the warm-up "
                             "and the timed search")
    flat, q = keep["flat"], keep["flat_q"]
    qd = torch.from_numpy(q).to(flat._emb[0].device)
    tab, valid = flat._emb[0], flat._valid[0]
    x_sq = (tab * tab).sum(-1)
    k = K
    err = check_topk(f"bench_sharded shard: l2_topk f32 n={tab.shape[0]} "
                     f"d={tab.shape[1]} b={qd.shape[0]} k={k}",
                     *l2_topk(qd, tab, valid, k, x_sq=x_sq),
                     *l2_topk_plain(qd, tab, valid, k + 1, x_sq), group=k,
                     scale=terms(qd, x_sq))
    p11_time(torch, kernels, "l2_topk_p11_shard", card,
             "bench_sharded flat shard", qd, tab, valid, k, x_sq, err)
    kernels["l2_topk_p11_shard"]["launches"] = sum(searches)
    keep.clear()


def p11_api(torch, kernels, card, one):
    """bench_api_torch at P11_API_DOCS documents, its two services as
    children: /health at the document count, /stats names the card, both
    children gone at the end. Returns the indexing child's (f32, bf16)
    l2_topk launches (read from its /stats by the script)."""
    keep = {}
    res = one("bench_api_torch", P11_API_DOCS, "BENCH_API_TORCH.json",
              n_queries=P11_API_QUERIES, keep=keep)
    name = torch.cuda.get_device_name(0)
    if res["health"]["index_size"] != P11_API_DOCS:
        raise AssertionError(f"bench_api /health: {res['health']}")
    if not any(name in d for d in res["stats_devices"]):
        raise AssertionError(f"bench_api /stats: {res['stats_devices']}")
    alive = [p.pid for p in keep["procs"] if p.poll() is None]
    if len(keep["procs"]) != 2 or alive:
        raise AssertionError(f"bench_api children still running: {alive}")
    rows = _row_launches(res).values()
    log(f"phase 11 bench_api: /health index size {P11_API_DOCS}, /stats "
        f"names {res['stats_devices']}, both children ended (codes "
        f"{[p.returncode for p in keep['procs']]})")
    return (sum(r.get("l2_topk", 0) for r in rows),
            sum(r.get("l2_topk_bf16", 0) for r in rows))


def phase_tail_drivers(torch, kernels, card, dev):
    """Phase 11: the last four JAX drivers by the port's
    scripts/bench_{insert,tiered,sharded,api}_torch.py at the JAX scripts'
    sizes: three in this process, the API's services as two child
    processes. Each script's line is logged, every key of the committed
    BENCH_{INSERT,TIERED,SHARDED,API}.json held by name, each recall to the
    JAX reading less P11_SLACK, each row's kernels as launched, the
    scripts' facts (flushes, restart, self top-1, no deleted id, filters,
    the children), and the new shapes of l2_topk against their plain
    versions with their times."""
    from pathlib import Path

    t0 = time.perf_counter()
    modules = dict(zip(P11_SCRIPTS, _scripts(P11_SCRIPTS)))
    jax = _p11_jax(Path(__file__).resolve().parent)
    counts, seconds = {}, {}

    def one(name, n, out_name, **kw):
        t1 = time.perf_counter()
        _reset_counts()
        res, line = _run_script(modules[name], n, dev, out_name, **kw)
        counts[name] = _counts()
        seconds[name] = time.perf_counter() - t1
        log(f"phase 11 {name} result [{card}]: {line}")
        held = p11_hold(name, res, jax[name])
        rows = p11_row_kernels(name, res)
        log(f"phase 11 {name}: every key of the JAX file present; recalls "
            f"(port, JAX) {held}; row launches {rows}; launches in this "
            f"process {counts[name]} ({seconds[name]:.1f} s)")
        return res

    p11_insert(torch, kernels, card, dev, one)
    gc.collect()
    torch.cuda.empty_cache()
    p11_tiered(torch, kernels, card, one)
    gc.collect()
    torch.cuda.empty_cache()
    p11_sharded(torch, kernels, card, one)
    gc.collect()
    torch.cuda.empty_cache()
    api_f32, api_bf16 = p11_api(torch, kernels, card, one)
    total = {k: sum(c[k] for c in counts.values()) for k in _counts()}
    # the launches outside the new shapes' records (the 1-row inserts, the
    # tiered ingest and truth, the sharded build's knn_exact, the API's)
    timed = [kernels[f"l2_topk_p11_{t}"]["launches"] for t in (
        *(f"b{bs}" for bs in modules["bench_insert_torch"].BATCHES),
        "shard")]
    if min(timed) <= 0 or sum(timed) > total["l2_topk"] or \
            kernels["l2_topk_bf16_p11"]["launches"] > total["l2_topk_bf16"]:
        raise AssertionError(f"phase 11: records {timed} against {total}")
    kernels["l2_topk"]["launches"] += total["l2_topk"] - sum(timed) + api_f32
    kernels["l2_topk_bf16"]["launches"] += (
        total["l2_topk_bf16"] - kernels["l2_topk_bf16_p11"]["launches"]
        + api_bf16)
    _launched("phase 11", total, ("l2_topk", "l2_topk_bf16"))
    if total["sorted_topk"] or api_f32 <= 0 or api_bf16 <= 0:
        raise AssertionError(f"phase 11 launches: {total}; the API's "
                             f"indexing process {api_f32} f32, {api_bf16} "
                             "bf16")
    log(f"phase 11 seconds per script {seconds}; launches in this process "
        f"{total}, in the API's indexing process l2_topk f32 {api_f32}, "
        f"bf16 {api_bf16}")
    log(f"phase 11 ok on {card} ({time.perf_counter() - t0:.1f} s)")

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    from vector_db_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    global BOOST_MHZ
    BOOST_MHZ = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(card)
    log(f"max SM clock {BOOST_MHZ} MHz (nvidia-smi clocks.max.sm)")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: "
        f"{torch.cuda.get_device_name(0)}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 1 ok: kernels built from {_build.CSRC} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds} s)")

    dev = torch.device("cuda", 0)
    kernels = {
        "l2_topk": {"name": "l2_topk", "route": "cuda",
                    "source": "vector_db_tpu_torch/csrc/l2_topk.cu",
                    "replaces": "vector_db_tpu/ops/pallas/l2_topk.py:70"},
        "l2_topk_10m": {"name": "l2_topk_10m", "route": "cuda",
                        "source": "vector_db_tpu_torch/csrc/l2_topk.cu",
                        "replaces": "vector_db_tpu/ops/pallas/l2_topk.py:70"},
        "l2_topk_bf16": {"name": "l2_topk_bf16", "route": "cuda",
                         "source": "vector_db_tpu_torch/csrc/l2_topk.cu",
                         "replaces":
                             "vector_db_tpu/ops/pallas/l2_topk.py:70"},
        "block_topm": {"name": "block_topm", "route": "cuda",
                       "source": "vector_db_tpu_torch/csrc/block_select.cu",
                       "replaces":
                           "vector_db_tpu/ops/pallas/block_topm.py:68"},
        "block_min": {"name": "block_min", "route": "cuda",
                      "source": "vector_db_tpu_torch/csrc/block_select.cu",
                      "replaces": "vector_db_tpu/ops/pallas/block_min.py:45"},
        "block_min_10m": {"name": "block_min_10m", "route": "cuda",
                          "source": "vector_db_tpu_torch/csrc/block_select.cu",
                          "replaces":
                              "vector_db_tpu/ops/pallas/block_min.py:45"},
        "adc_probe": {"name": "adc_probe", "route": "cuda",
                      "source": "vector_db_tpu_torch/csrc/adc_probe.cu",
                      "replaces": "vector_db_tpu/ops/pallas/adc_probe.py:61"},
        "adc_topk": {"name": "adc_topk", "route": "cuda",
                     "source": "vector_db_tpu_torch/csrc/adc_scan.cu",
                     "replaces": "vector_db_tpu/ops/pallas/adc_scan.py:80"},
        "l2_topk_p10": {"name": "l2_topk_p10", "route": "cuda",
                        "source": "vector_db_tpu_torch/csrc/l2_topk.cu",
                        "replaces": "vector_db_tpu/ops/pallas/l2_topk.py:70"},
        "block_min_p10": {"name": "block_min_p10", "route": "cuda",
                          "source": "vector_db_tpu_torch/csrc/block_select.cu",
                          "replaces":
                              "vector_db_tpu/ops/pallas/block_min.py:45"},
        "adc_topk_p10_k100": {"name": "adc_topk_p10_k100", "route": "cuda",
                              "source":
                                  "vector_db_tpu_torch/csrc/adc_scan.cu",
                              "replaces":
                                  "vector_db_tpu/ops/pallas/adc_scan.py:80"},
        "adc_topk_p10_k400": {"name": "adc_topk_p10_k400", "route": "cuda",
                              "source":
                                  "vector_db_tpu_torch/csrc/adc_scan.cu",
                              "replaces":
                                  "vector_db_tpu/ops/pallas/adc_scan.py:80"},
        "l2_topk_p11_b1024": {"name": "l2_topk_p11_b1024", "route": "cuda",
                              "source": "vector_db_tpu_torch/csrc/l2_topk.cu",
                              "replaces":
                                  "vector_db_tpu/ops/pallas/l2_topk.py:70"},
        "l2_topk_p11_b4096": {"name": "l2_topk_p11_b4096", "route": "cuda",
                              "source": "vector_db_tpu_torch/csrc/l2_topk.cu",
                              "replaces":
                                  "vector_db_tpu/ops/pallas/l2_topk.py:70"},
        "l2_topk_p11_shard": {"name": "l2_topk_p11_shard", "route": "cuda",
                              "source": "vector_db_tpu_torch/csrc/l2_topk.cu",
                              "replaces":
                                  "vector_db_tpu/ops/pallas/l2_topk.py:70"},
        "l2_topk_bf16_p11": {"name": "l2_topk_bf16_p11", "route": "cuda",
                             "source": "vector_db_tpu_torch/csrc/l2_topk.cu",
                             "replaces":
                                 "vector_db_tpu/ops/pallas/l2_topk.py:70"},
        "sorted_topk": {"name": "sorted_topk", "route": "cuda",
                        "source": "vector_db_tpu_torch/csrc/sorted_topk.cu",
                        "replaces":
                            "vector_db_tpu/ops/pallas/bitonic_merge.py:221"},
    }
    phase_kernels(torch, dev, kernels)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_main_path(torch, kernels)
    log(f"phase 3 ok on {card} ({time.perf_counter() - t0:.1f} s)")
    # phase 3's four 1M x 768 indexes were its locals: gone on return;
    # hand their cached blocks back before the IVF build
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_ivf_pq(torch, kernels)
    log(f"phase 4 ok on {card} ({time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_hnsw(torch, kernels)
    log(f"phase 5 ok on {card} ({time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    base = phase_services(torch, kernels, card)
    t0 = time.perf_counter()
    phase_sharding(torch, kernels, card, base)
    del base
    log(f"phase 7b ok on {card} ({time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    phase_bench(torch, kernels, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_10m(torch, kernels, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_bench_scripts(torch, kernels, card, dev)
    # phase 10's indexes were its locals; the API's children of phase 11
    # find the card's memory free
    gc.collect()
    torch.cuda.empty_cache()
    phase_tail_drivers(torch, kernels, card, dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    if any(m == "vector_db_tpu" or m.startswith("vector_db_tpu.")
           for m in sys.modules):
        raise AssertionError("a module of the JAX package was imported")

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    log(card)
    log(json.dumps({"kernels": [{key: kv[key] for key in order}
                                 for kv in kernels.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
