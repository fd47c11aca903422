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
   own f32 scan, with QPS, peak memory and each kernel's launch count.

The last line is {"ok": true, "device": {...}}; the line before it is the
kernels' JSON record, and the one before that the card's name and power
limit. Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import json
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
# difference of terms that large) and 0 for the block scans
RTOL, ATOL = 1e-5, 1e-4
LIVE = 1e37             # below this a value belongs to a real row


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


def check_topk(name, got_v, got_i, want_v, want_i, group: int,
               scale=0.0) -> float:
    """Values within tolerance, equal sentinels, ids equal wherever a value
    is apart from its neighbours (within groups of ``group`` ascending
    entries). ``scale``: per-row term size, [rows] or scalar. Returns the
    max abs error over live values."""
    gv, wv = got_v.cpu().double().numpy(), want_v.cpu().double().numpy()
    gv, wv = gv.reshape(-1, group), wv.reshape(-1, group)
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
    wi = want_i.cpu().numpy().reshape(-1, group)
    gap = np.abs(np.diff(wv, axis=1))
    apart = np.ones(wv.shape, bool)
    apart[:, 1:] &= gap > tol[:, 1:]
    apart[:, :-1] &= gap > tol[:, :-1]
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
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk, l2_topk_plain

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
        want = l2_topk_plain(q, tab, valid, k, x_sq)
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

    err = {"l2_topk": 0.0, "block_topm": 0.0, "block_min": 0.0}
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
        want = l2_topk_plain(q, tab, valid, K, x_sq)
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
        log(f"{name} bf16 table N={N_MAIN} ds={DS} B={B}"
            f"{' m=%d' % M_2P if name == 'block_topm' else ''}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
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

    # f32 against float64 ground truth over the live corpus
    live = np.ones(CORPUS, bool)
    live[deleted] = False
    q64 = queries[:8].astype(np.float64)
    d64 = np.empty((8, CORPUS))
    for s in range(0, CORPUS, 65536):
        xc = x[s:s + 65536].astype(np.float64)
        d64[:, s:s + 65536] = ((xc * xc).sum(1)[None, :] - 2 * q64 @ xc.T
                               + (q64 * q64).sum(1)[:, None])
    d64 = np.sqrt(np.maximum(np.where(live[None, :], d64, np.inf), 0))
    kth = np.sort(d64, axis=1)[:, K - 1]
    got = np.take_along_axis(d64, results["f32"][1][:8], axis=1)
    if not (got <= (1 + 1e-5) * kth[:, None]).all():
        raise AssertionError("f32: a returned id lies beyond the float64 "
                             "k-th distance")
    log("f32 exact against float64 ground truth on 8 queries: ok")

    truth = results["f32"][1]
    floors = {"bf16": 0.99, "blocksel": 0.999, "blocksel2p": 0.999}
    recalls = {}
    for p, floor in floors.items():
        hits = sum(len(set(a) & set(b)) for a, b in
                   zip(results[p][1].tolist(), truth.tolist()))
        recalls[p] = hits / truth.size
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
    }
    phase_kernels(torch, dev, kernels)
    torch.cuda.empty_cache()
    phase_main_path(torch, kernels)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(f"phase 3 ok on {card}")

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms")
    log(card)
    log(json.dumps({"kernels": [{key: kv[key] for key in order}
                                for kv in kernels.values()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
