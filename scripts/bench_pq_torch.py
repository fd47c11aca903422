#!/usr/bin/env python
"""BASELINE.md config 3: the SIFT1M PQ benchmark (m = 16, nbits = 8; 32x)
of scripts/bench_pq.py on the PyTorch + CUDA port, at 1M x 128.

    python3 scripts/bench_pq_torch.py

The corpus is ``datasets.sift_like(1M, 128, seed=0, queries=1000)`` (the
real TEXMEX files instead when SIFT1M_DIR points at them). For ``pq`` (no
rotation) and ``opq`` (8 OPQ iterations), each a PQCodec trained with 2
restarts on 131,072 rows drawn by ``default_rng(0)``:

- ``train_s`` and ``encode_vps`` (the corpus encoded from the device table
  in chunks of 8,192);
- ADC recall@100 and QPS: the ``adc_topk`` kernel over the 1M x 16 codes
  at k = 100, against the exact f32 top 100 on ``l2_topk``;
- fetch-4x + exact rerank: ``adc_topk`` at k = 400, the 400 candidates'
  rows gathered and scored exactly in f32, the top 100 kept
  (scripts/bench_pq.py:82-94).

Each QPS is timed as scripts/bench_sift.py's ``timed`` times a row: 3
warm-up calls, then 3 reps on perturbed inputs, each ending in a sync; the
inputs are the LUT (ADC) and the LUT with the queries (rerank), built
outside the timed call as scripts/bench_pq.py builds them (it times one
call); ``*_device_ms`` the median rep from CUDA events. Not carried over:
the compile cache, and the jit of the rerank (whose arguments are arrays so
that a remote compile is not handed the corpus as constants).

Writes BENCH_PQ_TORCH.json with the card's name and power limit, and
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
    ROOT, card, cli, finish, header, host, launch_counts, launches_since,
    log, recall_of, sift_corpus, sync, timed)
from vector_db_tpu_torch.index.pq import (  # noqa: E402
    PQCodec,
    _adc_lut,
    _encode_scan,
)
from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk_long  # noqa: E402
from vector_db_tpu_torch.ops.distance import gather_l2_sq  # noqa: E402
from vector_db_tpu_torch.ops.exact import exact_search_tiled  # noqa: E402
from vector_db_tpu_torch.ops.topk import masked_top_k_smallest  # noqa: E402

N, DIM, B, K = 1_000_000, 128, 1000, 100
TRAIN = 131072
CODECS = (("pq", 0), ("opq", 8))


def rerank(lut, q, codes, table, valid, k: int = K):
    """scripts/bench_pq.py's rerank: the ADC top 4k, their rows' exact f32
    distances, the top k."""
    _, i4 = adc_topk_long(lut, codes, valid, 4 * k)
    dv = gather_l2_sq(q, table, i4, torch.ones_like(i4, dtype=torch.bool))
    return masked_top_k_smallest(dv, i4, k)


def run(n: int, device, out_path, source: dict | None = None) -> dict:
    """The benchmark over ``n`` rows on ``device``; ``source`` (numpy
    ``x``, ``q``, optional ``data`` label) in place of the corpus. Writes
    ``out_path``, prints the one result line and returns the results."""
    dev = torch.device(device)
    gpu = card()
    corpus_np, q, label = sift_corpus(n, B, source)
    n = corpus_np.shape[0]
    log(f"bench_pq_torch on {dev} ({gpu}): data {label}")
    results = {"N": n, "dim": DIM, "m": 16, "nbits": 8, "k": K,
               "compression_x": DIM * 4 / 16, "data": label,
               **header(dev, gpu)}

    pad = (-n) % 8192
    corpus_dev = torch.from_numpy(np.concatenate(
        [corpus_np, np.zeros((pad, DIM), np.float32)]) if pad
        else corpus_np).to(dev)
    table = corpus_dev[:n]
    qd = torch.from_numpy(np.asarray(q, np.float32)).to(dev)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    log("exact ground truth...")
    gt = host(exact_search_tiled(qd, table, valid, K, tile=31250)[1])

    rng = np.random.default_rng(0)
    train_rows = corpus_np[rng.choice(n, min(TRAIN, n), replace=False)]

    for label_c, opq_iters in CODECS:
        codec = PQCodec(k=256, chunks=16, dim=DIM, device=dev)
        t0 = time.perf_counter()
        codec.train(train_rows, seed=0, restarts=2, opq_iters=opq_iters)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        codes = _encode_scan(corpus_dev, codec.codebooks, chunk=8192,
                             rotation=codec.rotation)[:n]
        sync(codes)
        encode_s = time.perf_counter() - t0
        log(f"[{label_c}] train {train_s:.1f}s encode {encode_s:.1f}s "
            f"({n / encode_s:.0f} vec/s)")

        lut = _adc_lut(codec.rotate_queries(q), codec.codebooks)
        before = launch_counts()
        ids = host(adc_topk_long(lut, codes, valid, K)[1])
        rec = recall_of(ids, gt, K)
        qps, dms = timed(lambda v: adc_topk_long(v, codes, valid, K), lut, B)
        log(f"[{label_c}] ADC scan: recall@{K}={rec:.3f} qps={qps:.0f}")
        adc_launches = launches_since(before)
        before = launch_counts()

        _, i_r = rerank(lut, qd, codes, table, valid)
        rec_rr = recall_of(host(i_r), gt, K)
        qps_rr, dms_rr = timed(
            lambda v: rerank(v[0], v[1], codes, table, valid), (lut, qd), B)
        log(f"[{label_c}] fetch-4x + exact rerank: recall@{K}={rec_rr:.3f} "
            f"qps={qps_rr:.0f}")
        results[label_c] = {
            "train_s": train_s, "encode_vps": n / encode_s,
            "adc_recall_at_100": rec, "adc_qps": qps, "adc_device_ms": dms,
            "rerank_recall_at_100": rec_rr, "rerank_qps": qps_rr,
            "rerank_device_ms": dms_rr, "adc_launches": adc_launches,
            "rerank_launches": launches_since(before)}
        del codes, lut
    return finish(results, out_path)


def main() -> int:
    return cli("bench_pq_torch", lambda dev: run(
        N, dev, ROOT / "BENCH_PQ_TORCH.json"))


if __name__ == "__main__":
    sys.exit(main())
