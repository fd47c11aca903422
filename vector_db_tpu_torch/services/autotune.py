"""Self-calibrating operating-point selection ("serve a recall target"); the
port of vector_db_tpu/services/autotune.py.

The engine exposes several search formulations over one HNSW table —
f32-exact scan, bf16 scan, block-select scan, wide-beam traversal at any
ef — whose recall/cost ranking depends on corpus size, dimensionality, data
distribution, and batch size (scans win large batches, traversal wins
small ones). The reference leaves this choice to the caller entirely (a
raw ``ef`` knob, src/vector_db/api/models.py:19; no recall feedback of any
kind).

``AutoTuner`` closes the loop: given ``target_recall``, it draws
calibration queries from the live corpus, computes exact ground truth on
the index's device (the f32 scan, ``l2_topk`` on the card — the recall-1.0
contract path), measures each candidate mode's recall and wall-clock at the
serving batch size, and routes to the cheapest mode that meets the target.
Decisions are cached per (batch-bucket, target, selectivity bucket) and
invalidated when the corpus grows or shrinks materially (recall at fixed
budget drifts with N).

The calibration draw is the JAX package's: the same ``default_rng(seed)``
choice over the live ids in the index's insertion order, so both packages
calibrate on the same rows. Every candidate returns host ids, so each timed
call ends in the device-to-host copy of its results, which waits for the
device.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vector_db_tpu_torch.ops.exact import exact_search_tiled


def _up2(v: int, lo: int = 8) -> int:
    return max(lo, 1 << (int(v) - 1).bit_length())


# filtered-query selectivity buckets (fraction of the corpus matching):
# decisions are cached per bucket — the scan/graph ranking flips with
# selectivity (at 10% the masked scan wins, while at ~50% the graph barely
# notices the mask)
_SEL_BUCKETS = (1.0, 0.5, 0.2, 0.1, 0.05, 0.02, 0.01, 0.003)


def _sel_bucket(frac: float) -> float:
    """Nearest (log-space) selectivity bucket for a match fraction."""
    frac = min(max(float(frac), 1e-6), 1.0)
    return min(_SEL_BUCKETS, key=lambda b: abs(math.log(b / frac)))


def _self_excluded(gt_ids: np.ndarray, pick: np.ndarray, k: int
                   ) -> np.ndarray:
    """int64[rows, k] ground truth: each row's ids but the query's own,
    -1 padded."""
    gt = np.full((gt_ids.shape[0], k), -1, np.int64)
    for r in range(gt.shape[0]):
        row = [int(i) for i in gt_ids[r]
               if int(i) >= 0 and int(i) != int(pick[r])]
        gt[r, : min(k, len(row))] = row[:k]
    return gt


class AutoTuner:
    """Calibrated mode router for one HNSW- or IVF-backed service.

    Parameters
    ----------
    target_recall : default recall@k floor a mode must meet.
    sample : calibration query count (drawn from live rows; ground truth
        and recall both exclude the query row itself, so no held-out set
        is needed).
    ef_ladder : wide-beam budgets to evaluate, cheapest first.
    reps : timed repetitions per candidate (median taken).
    grow_factor : recalibrate when size leaves
        [size_at_cal / grow_factor, size_at_cal * grow_factor].
    """

    def __init__(
        self,
        target_recall: float = 0.95,
        sample: int = 256,
        k: int = 10,
        ef_ladder: Tuple[int, ...] = (64, 128, 256, 512, 1024),
        reps: int = 2,
        grow_factor: float = 1.5,
        seed: int = 0,
    ) -> None:
        self.target_recall = float(target_recall)
        self.sample = int(sample)
        self.k = int(k)
        self.ef_ladder = tuple(int(e) for e in ef_ladder)
        self.reps = int(reps)
        self.grow_factor = float(grow_factor)
        self.seed = int(seed)
        # (batch_bucket, target, sel_bucket) -> decision dict
        # (sel_bucket 1.0 = unfiltered)
        self._decisions: Dict[Tuple[int, float, float],
                              Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._cal_queries: Optional[np.ndarray] = None
        self._cal_gt: Optional[np.ndarray] = None  # int64[sample, k]
        # sel_bucket -> (filter id set, filtered gt int64[sample, k])
        self._cal_filters: Dict[float, Tuple[set, np.ndarray]] = {}
        self._cal_size = 0  # index size the calibration set was drawn at

    # ---------------------------------------------------------------- state

    def stats(self) -> Dict[str, Any]:
        """Decision table for /stats: one row per (bucket, target,
        selectivity)."""
        return {
            (f"b{bucket}@{target:g}" if selb == 1.0
             else f"b{bucket}@{target:g}/sel{selb:g}"): {
                kk: vv for kk, vv in dec.items() if kk != "candidates"
            }
            for (bucket, target, selb), dec in self._decisions.items()
        }

    def invalidate(self) -> None:
        self._decisions.clear()
        self._cal_queries = None
        self._cal_gt = None
        self._cal_filters = {}
        self._cal_size = 0

    def _fresh(self, size: int) -> bool:
        if not self._cal_size:
            return False
        lo = self._cal_size / self.grow_factor
        hi = self._cal_size * self.grow_factor
        return lo <= size <= hi

    # ---------------------------------------------------------- calibration

    def _draw_calibration(self, index) -> None:
        """Sample live rows as queries; exact ground truth excluding self.

        Ground truth comes straight from the device table via
        ``exact_search_tiled`` (the f32 scan: ``l2_topk`` on the card), so
        it is identical for every index family."""
        ids = np.fromiter(index._slot_of_id.keys(), dtype=np.int64)
        rng = np.random.default_rng(self.seed)
        take = min(self.sample, ids.size)
        pick = rng.choice(ids, size=take, replace=False)
        emb = index._emb
        slots = torch.tensor([index._slot_of_id[int(i)] for i in pick],
                             dtype=torch.int64, device=emb.device)
        q_dev = emb[slots]
        # self-exclusion: ask for k+1 exact neighbors, drop the query row
        cap = emb.shape[0]
        _, gt_slots = exact_search_tiled(q_dev, emb, index._has_emb,
                                         self.k + 1, tile=min(cap, 32768))
        gt_ids = index._store.ids_of(gt_slots.cpu().numpy())
        self._cal_queries = q_dev.cpu().numpy()
        self._cal_ids = pick
        self._cal_gt = _self_excluded(gt_ids, pick, self.k)
        self._cal_size = index.size

    def _draw_filter(self, index, selb: float) -> Tuple[set, np.ndarray]:
        """Calibration filter at selectivity ``selb``: a seeded random
        subset of live ids, plus the exact FILTERED ground truth (the
        engine's own recall-1.0 contract path with the mask applied)."""
        cached = self._cal_filters.get(selb)
        if cached is not None:
            return cached
        ids = np.fromiter(index._slot_of_id.keys(), dtype=np.int64)
        rng = np.random.default_rng(self.seed + int(1e6 * selb))
        take = max(self.k + 1, int(round(ids.size * selb)))
        take = min(take, ids.size)
        fset = {int(i) for i in rng.choice(ids, size=take, replace=False)}
        _, gt_ids = index.search_batch_scan(
            self._cal_queries, self.k + 1, mode="exact", filter_ids=fset)
        gt = _self_excluded(gt_ids, self._cal_ids, self.k)
        self._cal_filters[selb] = (fset, gt)
        return fset, gt

    def _recall(self, ids: np.ndarray, gt: Optional[np.ndarray] = None
                ) -> float:
        """recall@k against the self-excluded ground truth; candidate
        rows carry k+1 ids (ascending) so dropping the query row itself
        still leaves k real candidates."""
        if gt is None:
            gt = self._cal_gt
        hits = 0
        total = 0
        for r in range(gt.shape[0]):
            want = {int(i) for i in gt[r] if int(i) >= 0}
            if not want:
                continue
            self_id = int(self._cal_ids[r])
            got = [int(i) for i in ids[r]
                   if int(i) >= 0 and int(i) != self_id][: self.k]
            hits += len(set(got) & want)
            total += len(want)
        return hits / max(total, 1)

    def _measure(
        self, run: Callable[[np.ndarray], np.ndarray], bucket: int,
        gt: Optional[np.ndarray] = None,
    ) -> Tuple[float, float]:
        """(recall, queries/s) of ``run`` fed ``bucket``-sized batches.

        Batches are padded to the bucket with repeated calibration rows
        so the timing shape matches the serving shape even when the
        sample is smaller than the batch (padding is identical across
        candidates, so the ranking stays fair); recall only reads the
        real rows. ``run`` returns host ids, so each timed call ends when
        the device has finished it."""
        q = self._cal_queries
        n = q.shape[0]
        batches, real = [], []
        for s in range(0, n, bucket):
            b = q[s: s + bucket]
            r = b.shape[0]
            if r < bucket:
                pad = np.tile(q, (-(-(bucket - r) // n), 1))[: bucket - r]
                b = np.concatenate([b, pad])
            batches.append(b)
            real.append(r)
        ids = np.concatenate(
            [run(b)[:r] for b, r in zip(batches, real)], axis=0)  # warm
        rec = self._recall(ids, gt)
        times: List[float] = []
        for _ in range(self.reps):
            t0 = time.perf_counter()
            for b in batches:
                run(b)
            times.append(time.perf_counter() - t0)
        return rec, n / float(np.median(times))

    def _candidates(self, service, bucket: int):
        """(name, params, run) per mode, roughly cheapest-first so ties
        resolve toward the simpler program. Each run asks for k+1 ids:
        calibration queries are live rows, so the row itself tops every
        result list and _recall drops it."""
        index = service.index
        k = self.k + 1
        if service.index_type == "ivf":
            use_rp = service._maybe_enable_rp()
            use_pq = (not use_rp
                      and service._maybe_enable_pq(None))
            ladder = sorted({min(p, index.k) for p in (8, 16, 32, 64,
                                                       128, 256, 512)})
            return [(
                "ivf", {"n_probe": np_, "rp": use_rp, "pq": use_pq},
                lambda b, np_=np_: index.search_batch(
                    b, n_probe=np_, top_k=k, pq=use_pq, rp=use_rp,
                    adc=service._pq_adc)[1],
            ) for np_ in ladder]
        out = []
        out.append((
            "scan-bf16", {"mode": "bf16"},
            lambda b: index.search_batch_scan(b, k, mode="bf16")[1],
        ))
        out.append((
            "scan-blocksel", {"mode": "blocksel"},
            lambda b: index.search_batch_scan(b, k, mode="blocksel")[1],
        ))
        if service._maybe_enable_wide():
            for ef in self.ef_ladder:
                out.append((
                    "wide", {"ef": ef},
                    lambda b, ef=ef: index.search_batch_wide(
                        b, k, ef=ef, seen_mask=service._wide_seen,
                        merge_kernel=service._resolve_merge_kernel())[1],
                ))
        out.append((
            "scan-exact", {"mode": "exact"},
            lambda b: index.search_batch_scan(b, k, mode="exact")[1],
        ))
        return out

    def _candidates_filtered(self, service, fset):
        """Filtered-mode ladder: the masked bf16 scan (true filtered
        top-k at scan QPS) vs the two-pool wide graph at widened
        (ef, rerank_k) — selective filters need a deep result pool
        (reference contract hnsw.py:81-88,96-97,127-131)."""
        index = service.index
        k = self.k + 1
        out = [(
            "scan-bf16-f", {"mode": "bf16"},
            lambda b: index.search_batch_scan(
                b, k, mode="bf16", filter_ids=fset)[1],
        )]
        if service._maybe_enable_wide():
            for ef, rk in ((512, 256), (1024, 512), (1536, 512)):
                out.append((
                    "wide-f", {"ef": ef, "rerank_k": rk},
                    lambda b, ef=ef, rk=rk: index.search_batch_wide(
                        b, k, ef=ef, rerank_k=rk, filter_ids=fset,
                        seen_mask=service._wide_seen,
                        merge_kernel=service._resolve_merge_kernel())[1],
                ))
        out.append((
            "scan-exact-f", {"mode": "exact"},
            lambda b: index.search_batch_scan(
                b, k, mode="exact", filter_ids=fset)[1],
        ))
        return out

    def decision_for(
        self, service, batch_size: int, target: Optional[float] = None,
        sel_frac: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Cached calibrated decision for this batch size, target, and
        (for filtered queries) selectivity bucket."""
        target = self.target_recall if target is None else float(target)
        bucket = _up2(batch_size)
        selb = 1.0 if sel_frac is None else _sel_bucket(sel_frac)
        key = (bucket, target, selb)
        if self._fresh(service.index.size):
            dec = self._decisions.get(key)
            if dec is not None:
                return dec
        with self._lock:  # calibration mutates shared state; recheck
            size = service.index.size
            if not self._fresh(size):
                self.invalidate()
            dec = self._decisions.get(key)
            if dec is not None:
                return dec
            if self._cal_queries is None:
                self._draw_calibration(service.index)
            if selb < 1.0:
                fset, gt = self._draw_filter(service.index, selb)
                cands = self._candidates_filtered(service, fset)
            else:
                gt = None
                cands = self._candidates(service, bucket)
            rows = []
            for name, params, run in cands:
                rec, qps = self._measure(run, bucket, gt)
                rows.append({"name": name, "params": params,
                             "recall": round(rec, 4),
                             "qps": round(qps, 1)})
            meeting = [r for r in rows if r["recall"] >= target]
            if meeting:
                best = max(meeting, key=lambda r: r["qps"])
            else:  # nothing meets the target: highest recall wins
                best = max(rows, key=lambda r: (r["recall"], r["qps"]))
            dec = {"mode": best["name"], "params": best["params"],
                   "recall": best["recall"], "qps": best["qps"],
                   "target": target, "met": best["recall"] >= target,
                   "calibrated_at_size": size, "bucket": bucket,
                   "candidates": rows}
            if selb < 1.0:
                dec["selectivity"] = selb
            self._decisions[key] = dec
            return dec

    # -------------------------------------------------------------- routing

    def route(self, service, queries: np.ndarray, k: int,
              target: Optional[float] = None, filter_ids=None):
        """Run the calibrated best mode on ``queries``.

        Returns the (dists, ids) pair of the underlying mode. ``k`` may
        differ from the calibration k — recall transfers well across
        nearby k for every mode here (all are budgeted by ef / scan
        width, not by k). ``filter_ids`` routes through the decision of
        the matching selectivity bucket and applies the REAL filter."""
        index = service.index
        if filter_ids is not None:
            frac = len(filter_ids) / max(1, index.size)
            dec = self.decision_for(service, len(queries), target, frac)
            p = dec["params"]
            if dec["mode"] == "wide-f":
                return index.search_batch_wide(
                    queries, k, ef=int(p["ef"]),
                    rerank_k=int(p["rerank_k"]), filter_ids=filter_ids,
                    seen_mask=service._wide_seen,
                    merge_kernel=service._resolve_merge_kernel())
            return index.search_batch_scan(
                queries, k, mode=p["mode"], filter_ids=filter_ids)
        dec = self.decision_for(service, len(queries), target)
        if dec["mode"] == "ivf":
            p = dec["params"]
            return index.search_batch(
                queries, n_probe=int(p["n_probe"]), top_k=k,
                pq=bool(p["pq"]), rp=bool(p["rp"]),
                adc=service._pq_adc)
        if dec["mode"] == "wide":
            return index.search_batch_wide(
                queries, k, ef=int(dec["params"]["ef"]),
                seen_mask=service._wide_seen,
                merge_kernel=service._resolve_merge_kernel())
        return index.search_batch_scan(
            queries, k, mode=dec["params"]["mode"])
