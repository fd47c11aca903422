"""Drive the PyTorch + CUDA port (vector_db_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, one line or more each; any failure raises and the exit code is not 0:

1. device and build: the card's name and power limit, the TF32 flags (set
   off), and the nvcc build of the kernels from the checkout's sources;
2. each kernel against its plain PyTorch version on the card: edge shapes
   (ragged N, B = 1, B off the query tile, invalid rows, k above the valid
   rows, duplicate rows) and the main path's shapes, with both medians;
3. the main path at real size: FlatIndex over a 1M x 768 embedding-like
   corpus in all four precisions (insert, delete, filter, search_batch at
   B = 1000, k = 10), checked against float64 ground truth and the port's
   own f32 scan, with QPS, peak memory and each kernel's launch count;
4. IVF-PQ at SIFT1M scale, the repo's IVF benchmark setting (IVFADC of
   Jegou et al., FAISS IVF4096,PQ16): IvfIndex over 1M x 128 sift_like rows,
   4096 cells, residual PQ m = 16 with OPQ, add, delete, filter, and
   search_batch at B = 1000 in the PQ-probe (n_probe = 16, fetch = 512)
   and flat modes against the port's exact scan; then a PQCodec ADC scan
   of the corpus (adc_topk) against its gather mode, and a FlatIndex search
   at k = 300 (above l2_topk's 256) against float64;
5. HNSW at the repo's 1M benchmark setting (scripts/exp_wide_final.py:38-76,
   scripts/bench_1m.py:85-92): bulk_build of 1M x 768 embedding_like rows
   (M = 16, l_max = 5; level 0 clustered, level 1 through knn_exact and
   l2_topk, higher levels in numpy), 100 deletes, enable_wide(dims=128,
   seeds=16384), wide-beam search at ef = 1280, F = 224, T = 10 with and
   without the sorted_topk merge kernel, a filtered wide search at 10 %
   selectivity and the classic beam at ef = 400, all at B = 1000 against
   the port's exact scan; sorted_topk on the main path's own merge input.

Phases 3-5 also profile each search mode (torch.profiler over 3 calls):
device busy time, idle share of the wall time, the largest device items.

Each kernel's record carries its time, its plain version's, a library
call's where one PyTorch call computes the same function, and its bound:
the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over the card's peak for their type
(H100 SXM: 67 TFLOP/s f32, 989 TFLOP/s bf16 tensor cores).

The last line is {"ok": true, "device": {...}}; the line before it is the
kernels' JSON record, and the one before that the card's name and power
limit. Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import gc
import json
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
# LUT sum), and 0 for the block scans and adc_topk
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
# phase 5: HNSW at 1M x 768 (scripts/exp_wide_final.py:38-76)
HNSW_N = 1_000_000
HNSW_DIM = 768
HNSW_M = 16
HNSW_EFC = 200
HNSW_LMAX = 5
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
# peaks for the bound (H100 SXM datasheet, at 700 W)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, peak: float):
    """(ms, what sets it): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def set_bound(kernel, nbytes, ops, peak, library_ms=None) -> None:
    kernel["bound_ms"], kernel["bound_by"] = bound(nbytes, ops, peak)
    kernel["library_ms"] = library_ms


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
        xsq[::invalid_every] = 2e38
        q = randn(b, ds)
        tab = tab.to(dtype)
        vals, rows = block_topm_scan(q, tab, xsq, m=m)
        pv, pr = block_topm_plain(q, tab, xsq, m)
        e1 = check_topk(f"block_topm {dtype} n={n} b={b} m={m}", vals, rows,
                        pv, pr, group=m)
        e2 = check_topk(f"block_min {dtype} n={n} b={b}",
                        block_min_scan(q, tab, xsq), None,
                        block_min_plain(q, tab, xsq), None, group=1)
        return e1, e2

    def terms(q, x_sq):
        return ((q * q).sum(-1) + x_sq.max()).cpu().numpy()

    def adc_probe_case(b, p, m, ksub):
        lut = randn(b, m, ksub) ** 2
        codes = torch.randint(0, ksub, (b, p, m), generator=gen, device=dev,
                              dtype=torch.uint8)
        codes[:, 1] = codes[:, 0]
        corr = randn(b, p)
        valid = torch.rand(b, p, generator=gen, device=dev) > 0.2
        got = adc_probe_scores(lut, codes, corr, valid)
        want = adc_probe_plain(lut, codes, corr, valid)
        return check_topk(f"adc_probe b={b} p={p} m={m} ksub={ksub}", got,
                          None, want, None, group=p,
                          scale=adc_terms(lut, corr))

    def adc_topk_case(n, m, ksub, b, k, dtype, valid_rows=None):
        lut = randn(b, m, ksub) ** 2
        codes = torch.randint(0, ksub, (n, m), generator=gen, device=dev,
                              dtype=dtype)
        codes[1:6] = codes[0]
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[::9] = False
        if valid_rows is not None:
            valid[valid_rows:] = False
        got = adc_topk(lut, codes, valid, k)
        want = adc_topk_plain(lut, codes, valid, k + 1)
        return check_topk(f"adc_topk {dtype} n={n} m={m} ksub={ksub} b={b} "
                          f"k={k}", *got, *want, group=k)

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

    err = {"l2_topk": 0.0, "block_topm": 0.0, "block_min": 0.0,
           "adc_probe": 0.0, "adc_topk": 0.0, "sorted_topk": 0.0}
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
    for m in (4, 8, 16):
        for ksub in (16, 256):
            for b, p in ((1, 70), (7, 1000 + 3)):
                err["adc_probe"] = max(err["adc_probe"],
                                       adc_probe_case(b, p, m, ksub))
            for dtype in (torch.uint8, torch.int32):
                for n, b, k, vr in ((1000 + 7, 1, 10, None),
                                    (5000 + 70, 9, 100, None),
                                    (300, 3, 256, 200)):  # k > valid rows
                    err["adc_topk"] = max(err["adc_topk"], adc_topk_case(
                        n, m, ksub, b, k, dtype, valid_rows=vr))
    log(f"phase 2 adc edge shapes ok: max abs err {err}")
    for dtype in (torch.float32, torch.bfloat16):
        for n, d, b, k, vr in ((1000, 64, 1, 10, None),
                               (5000 + 70, 200, 70, 100, None),
                               (300, 32, 5, 256, 200),  # k > valid rows
                               (4096, 768, 130, 16, None)):
            err["l2_topk"] = max(err["l2_topk"],
                                 l2_case(n, d, b, k, dtype, valid_rows=vr))
        for n, ds, b, m in ((1000, 128, 1, 2), (4096 + 70, 200, 70, 4),
                            (300, 32, 5, 1)):
            e1, e2 = block_case(n, ds, b, m, dtype)
            err["block_topm"] = max(err["block_topm"], e1)
            err["block_min"] = max(err["block_min"], e2)
    log(f"phase 2 edge shapes ok: max abs err {err}")

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
        log(f"l2_topk {label} table N={N_MAIN} d={DIM} B={B} k={K}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, max abs err {e}")
        if label == "f32":
            kernels["l2_topk"].update(ms=ms, plain_ms=plain_ms)
            # reads: table, its norms and mask, the queries; the k-lists out
            set_bound(kernels["l2_topk"],
                      N_MAIN * DIM * 4 + N_MAIN * 5 + B * DIM * 4 + B * K * 8,
                      2.0 * B * N_MAIN * DIM, F32_FLOPS)
        del tab, x_sq, valid, got, want

    tab = randn(N_MAIN, DS).to(torch.bfloat16)
    xsq = torch.rand(N_MAIN, generator=gen, device=dev) * 10
    xsq[::97] = 2e38
    qs = randn(B, DS)
    vals, rows = block_topm_scan(qs, tab, xsq, m=M_2P)
    pv, pr = block_topm_plain(qs, tab, xsq, M_2P)
    e = check_topk("block_topm main", vals, rows, pv, pr, group=M_2P)
    err["block_topm"] = max(err["block_topm"], e)
    mins = block_min_scan(qs, tab, xsq)
    e2 = check_topk("block_min main", mins, None,
                    block_min_plain(qs, tab, xsq), None, group=1)
    err["block_min"] = max(err["block_min"], e2)
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
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
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
    log(f"adc_topk int32 codes N={N_MAIN} m={PQ_M} ksub={PQ_KSUB} B={ADC_B} "
        f"k={ADC_K}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"max abs err {e}")
    del lut, codes, valid, got, want
    for name in err:
        kernels[name]["max_abs_err"] = err[name]
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

    for fn in (adc_probe_scores, adc_topk, l2_topk):
        fn.launches = 0
    modes = {"ivf_pq": dict(pq=True, fetch=FETCH), "ivf_flat": {}}
    rng = np.random.default_rng(3)
    batches = [queries + 0.01 * rng.standard_normal(queries.shape).astype(
        np.float32) for _ in range(5)]
    results, qps = {}, {}
    for name, kw in modes.items():
        results[name] = ivf.search_batch(queries, N_PROBE, K, **kw)
        secs = []
        for i, qb in enumerate(batches):  # 2 warm-ups, 3 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ivf.search_batch(qb, N_PROBE, K, **kw)
            torch.cuda.synchronize()
            if i >= 2:
                secs.append(time.perf_counter() - t0)
        qps[name] = B / statistics.median(secs)
        log(f"{name}: QPS {qps[name]:.1f} (B={B}, n_probe={N_PROBE}, k={K}"
            f"{', fetch=%d' % FETCH if kw else ''}; median of 3 host-clock "
            "reps)")
    counts = {"adc_probe": adc_probe_scores.launches,
              "adc_topk": adc_topk.launches, "l2_topk": l2_topk.launches}
    log(f"launch counts on the IVF search path: {counts}")
    for name, kw in modes.items():
        profile(torch, name, lambda: ivf.search_batch(batches[0], N_PROBE, K,
                                                      **kw))
    if counts["adc_probe"] <= 0:
        raise AssertionError("adc_probe: no launch on the IVF-PQ path")
    kernels["adc_probe"]["launches"] = counts["adc_probe"]

    _, truth = exact_search_tiled(qd, ivf._emb, ivf._has_emb, K)
    truth = ivf._store.ids_of(truth.cpu().numpy())
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
    ms = cuda_ms(torch, lambda: adc_probe_scores(lut, codes, corr, ok))
    plain_ms = cuda_ms(torch, lambda: adc_probe_plain(lut, codes, corr, ok))
    kernels["adc_probe"].update(ms=ms, plain_ms=plain_ms)
    # reads: uint8 codes, LUTs, corr, mask; writes the f32 scores
    set_bound(kernels["adc_probe"],
              nb * p_cand * (PQ_M + 4 + 1 + 4) + nb * PQ_M * PQ_KSUB * 4,
              float(nb) * p_cand * (PQ_M + 1), F32_FLOPS)
    log(f"adc_probe B={nb} P={p_cand} (L={cell_slots.shape[1]}) m={PQ_M} "
        f"ksub={PQ_KSUB}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"max abs err {e}")
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
    kernels["adc_topk"]["launches"] = scan_launches
    kernels["adc_topk"]["max_abs_err"] = max(
        kernels["adc_topk"]["max_abs_err"], e)
    del codec, codes, ivf

    # FlatIndex at k = 300, above l2_topk's 256: the tiled plain branch
    sub = x[:131072]
    flat = FlatIndex(capacity=1 << 17, device="cuda")
    flat.insert_nodes([Node(id=i, embedding=sub[i])
                       for i in range(sub.shape[0])])
    launches = l2_topk.launches
    _, ids = flat.search_batch(queries[:8], 300)
    if l2_topk.launches != launches or ids.shape != (8, 300):
        raise AssertionError("FlatIndex k=300 did not take the plain branch")
    float64_bound("FlatIndex k=300", sub, queries[:8], ids, 300)
    log("FlatIndex f32 at k=300 over 131072 rows: within the float64 bound")
    log(f"IVF-PQ summary: build {build_s:.1f} s, enable_pq {pq_s:.1f} s, "
        f"QPS {qps}, recall@{K} {recalls}, peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")


def profile(torch, label, fn, reps: int = 3) -> None:
    """Device busy time of ``reps`` calls of ``fn`` under torch.profiler
    (the sum of the CUDA rows of key_averages), its idle share of the wall
    time, and the largest device items."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

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
        return
    top = sorted(rows, key=lambda r: -r.self_device_time_total)[:6]
    log(f"{label} profile: wall {wall * 1e3:.1f} ms/call, device busy "
        f"{busy * 1e3:.1f} ms/call, idle share {1 - busy / wall:.3f}; "
        "largest: " + "; ".join(
            f"{r.key[:48]} {r.self_device_time_total / reps / 1e3:.2f} ms "
            f"({r.count // reps}x)" for r in top))


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


def phase_hnsw(torch, kernels):
    """Phase 5: HNSW at 1M x 768: bulk build, delete, wide and classic
    search, and sorted_topk on the main path's own merge input."""
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
    log(f"corpus {HNSW_N} x {HNSW_DIM} and {B} queries made "
        f"({time.perf_counter() - t0:.1f} s, host)")
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts at 0 just before the build
    l2_topk.launches = 0
    sorted_topk.launches = 0
    t0 = time.perf_counter()
    idx = HNSW(M=HNSW_M, ef_construction=HNSW_EFC, rng=random.Random(42),
               capacity=HNSW_N, l_max=HNSW_LMAX, device="cuda")
    idx.bulk_build(range(HNSW_N), x, alpha=1.0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_l2 = l2_topk.launches
    lv = idx._levels_host
    per_level = [int((lv >= level).sum()) for level in range(HNSW_LMAX)]
    log(f"HNSW(M={HNSW_M}, l_max={HNSW_LMAX}).bulk_build: {build_s:.1f} s; "
        f"nodes per level {per_level}; l2_topk launches in the build "
        f"(knn_exact) {build_l2}")
    if build_l2 <= 0:
        raise AssertionError("bulk_build: no l2_topk launch under knn_exact")

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
    results, qps, launches = {}, {}, {}
    for name, kw in modes.items():
        call = idx.search_batch if name == "classic" else idx.search_batch_wide
        before = sorted_topk.launches
        results[name] = call(queries, **kw)
        secs = []
        for i, qb in enumerate(batches):  # 2 warm-ups, 3 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(qb, **kw)
            torch.cuda.synchronize()
            if i >= 2:
                secs.append(time.perf_counter() - t0)
        qps[name] = B / statistics.median(secs)
        launches[name] = sorted_topk.launches - before
        log(f"{name}: QPS {qps[name]:.1f} (B={B}, {kw}; median of 3 "
            "host-clock reps)")
    calls = 1 + len(batches)
    log(f"sorted_topk launches per mode: {launches} over {calls} calls each")
    for name, kw in modes.items():
        call = idx.search_batch if name == "classic" else idx.search_batch_wide
        profile(torch, name, lambda: call(batches[0], **kw))
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
        f" ms; keys equal, payloads equal within runs of equal keys")
    log(f"HNSW summary: build {build_s:.1f} s, QPS {qps}, recall@{K} "
        f"{recalls}, filtered recall {frec:.4f}, peak device memory {peak} "
        f"bytes ({peak / 2**30:.2f} GiB)")


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(card)
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
        "block_topm": {"name": "block_topm", "route": "cuda",
                       "source": "vector_db_tpu_torch/csrc/block_select.cu",
                       "replaces":
                           "vector_db_tpu/ops/pallas/block_topm.py:68"},
        "block_min": {"name": "block_min", "route": "cuda",
                      "source": "vector_db_tpu_torch/csrc/block_select.cu",
                      "replaces": "vector_db_tpu/ops/pallas/block_min.py:45"},
        "adc_probe": {"name": "adc_probe", "route": "cuda",
                      "source": "vector_db_tpu_torch/csrc/adc_probe.cu",
                      "replaces": "vector_db_tpu/ops/pallas/adc_probe.py:61"},
        "adc_topk": {"name": "adc_topk", "route": "cuda",
                     "source": "vector_db_tpu_torch/csrc/adc_scan.cu",
                     "replaces": "vector_db_tpu/ops/pallas/adc_scan.py:80"},
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
