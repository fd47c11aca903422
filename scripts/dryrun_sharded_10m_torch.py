#!/usr/bin/env python
"""10M x 768 split into 8 shards (BASELINE config 5, sharded): the design
of scripts/dryrun_sharded_10m.py on the PyTorch + CUDA port.

    python3 scripts/dryrun_sharded_10m_torch.py   # DRYRUN10M_N rows, 10M

scripts/bench_10m_torch.py's two-stage search, at the sharded script's
widths: DP = 128, an f32 projected mirror (``block_min_scan``'s f32 path),
an f32 rerank, chunks of 65,536 rows, 16 queries at blocks_k 32. Each of
the 8 shards owns a row range of ceil(N / 8) rows, generated chunk by chunk
on its own device from its own generator (seed 23 with the shard's index,
as the JAX script's ``fold_in(key(23), shard)``); it folds its exact top-k
of the queries on ``l2_topk`` and searches its own tables. The shards'
[16, 10] lists merge with ``parallel/sharded.py``'s ``_merge_gathered``
(global ids ``shard * shard_pad + local``), and the ground truth is the
shards' exact folds merged on the host.

The shards sit on the devices of ``parallel.mesh.make_mesh``'s list: every
visible card in turn, so all 8 on cuda:0 with one card.

Writes BENCH_SHARDED_10M_TORCH.json (with the card's name and power limit)
and prints it as one JSON line. Runs on the card only: without one it
prints no result and exits 1. Diagnostics go to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import bench_10m_torch as one  # noqa: E402
from bench_10m_torch import (  # noqa: E402
    DIM,
    K,
    ROOT,
    _host,
    gen,
    log,
    recall_vs,
)
from vector_db_tpu_torch.device import resolve_device  # noqa: E402
from vector_db_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from vector_db_tpu_torch.parallel.sharded import (  # noqa: E402
    _globalize,
    _merge_gathered,
)

DP, B = 128, 16
CHUNK = 65536
SHARDS = 8
BLOCKS_K = 32
SEED = 11               # the mixture and the queries
SHARD_SEED = 23         # shard s draws its rows from SHARD_SEED * 1000 + s
REPS = 3


def shard_devices(dev: torch.device) -> list:
    """The shards' devices: the CPU for a CPU run, else every visible card
    in turn."""
    if dev.type == "cpu":
        return [dev] * SHARDS
    return [torch.device("cuda", s % torch.cuda.device_count())
            for s in range(SHARDS)]


def shard_rows(mix: torch.Tensor, dev: torch.device, sid: int):
    """rows_of(ci) of shard ``sid``: its own generator on ``dev``, so the
    chunks are drawn in order, each once."""
    g = torch.Generator(device=dev).manual_seed(SHARD_SEED * 1000 + sid)
    mix = mix.to(dev)
    return lambda ci: gen(g, mix, CHUNK)


def build_shards(n: int, mesh: Mesh, queries: torch.Tensor,
                 proj: torch.Tensor, rows_of) -> list:
    """Each shard's tables (f32 mirror, f32 rerank) over its ceil(n /
    SHARDS) rows, on its own device; ``rows_of(sid)`` gives the shard's
    chunks."""
    per_shard = -(-n // SHARDS)
    return [one.build_tables(queries.to(dev), proj.to(dev), rows_of(sid),
                             per_shard, CHUNK, torch.float32,
                             rerank_dtype=torch.float32)
            for sid, dev in enumerate(mesh.devices)]


def plain_merge(dists, ids, k: int):
    """The shards' [b, k] lists merged on the host: the k smallest of
    their concatenation in shard order by a stable sort, so the lower
    shard, then the lower position, comes first on ties."""
    d = np.concatenate([np.asarray(x) for x in dists], axis=1)
    i = np.concatenate([np.asarray(x) for x in ids], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(d, order, axis=1),
            np.take_along_axis(i, order, axis=1))


def search_sharded(shards: list, mesh: Mesh, q: torch.Tensor,
                   qm: torch.Tensor, blocks_k: int):
    """Every shard's two-stage search on its own device, then the merge on
    the mesh's first device: (f32 [b, K], int32 [b, K] global ids) and the
    shards' lists (dists, global ids)."""
    shard_pad = shards[0].xi8.shape[0]
    dists, gids = [], []
    for sid, (t, dev) in enumerate(zip(shards, mesh.devices)):
        d, i = one.search(t, q.to(dev), qm.to(dev), blocks_k)
        dists.append(d)
        gids.append(_globalize(i, sid, shard_pad))
    md, mi = _merge_gathered(dists, gids, K, mesh)
    return md, mi, (dists, gids)


def run(n: int, device, out_path, source: dict | None = None) -> dict:
    """The sharded dry-run over ``n`` rows; ``source`` (numpy ``mix``,
    ``extra``, ``queries`` and ``chunks``, shard s's chunk ci at
    ``chunks[s][ci]``) in place of the script's own generators. Writes
    ``out_path``, prints the one result line and returns the results."""
    dev = torch.device(device)
    gpu = one.card()
    mesh = make_mesh(devices=shard_devices(dev))
    if source is None:
        mix, extra, queries, _ = one.own_source(dev, SEED, DP, B, CHUNK)

        def rows_of(sid):
            return shard_rows(mix, mesh.devices[sid], sid)
    else:
        mix, extra, queries, _ = one.given_source(source, dev)

        def rows_of(sid):
            return lambda ci: one.to_device(source["chunks"][sid][ci],
                                            mesh.devices[sid])
    proj = one.projection(mix, extra)
    per_shard = -(-n // SHARDS)
    n_chunks = -(-per_shard // CHUNK)
    log(f"dryrun_sharded_10m_torch on {[str(d) for d in mesh.devices]} "
        f"({gpu}): N={n}, {SHARDS} shards x {n_chunks} chunks of {CHUNK}")
    t0 = time.perf_counter()
    shards = build_shards(n, mesh, queries, proj, rows_of)
    shard_pad = shards[0].xi8.shape[0]
    folds = [(_host(t.truth[0]),
              _host(_globalize(t.truth[1], sid, shard_pad)))
             for sid, t in enumerate(shards)]
    build_s = time.perf_counter() - t0
    log(f"gen + truth + mirrors: {build_s:.1f} s")
    _, gt = plain_merge([f[0] for f in folds], [f[1] for f in folds], K)

    qm = queries @ proj
    t0 = time.perf_counter()
    _, ids, (dists, gids) = search_sharded(shards, mesh, queries, qm,
                                             BLOCKS_K)
    ids = _host(ids)
    search_s = time.perf_counter() - t0
    rec = recall_vs(ids, gt)
    _, want = plain_merge([_host(d) for d in dists],
                          [_host(g) for g in gids], K)
    if not np.array_equal(ids, want):
        raise AssertionError("the merge differs from a plain stable merge "
                             "of the shards' lists")
    _, reps = one.timed(
        lambda qv, qmv: search_sharded(shards, mesh, qv, qmv,
                                       BLOCKS_K)[:2],
        queries, proj, REPS)
    wall, dev_ms = one.medians(reps)
    log(f"recall@{K}={rec:.4f}; first search {search_s:.3f} s, warm "
        f"{wall:.4f} s ({dev_ms} device ms)")
    results = {
        "N": n, "dim": DIM, "dp": DP, "shards": SHARDS,
        "shard_devices": [str(d) for d in mesh.devices],
        "per_shard": per_shard, "shard_pad": shard_pad, "queries": B,
        "blocks_k": BLOCKS_K, "build_s": build_s, "recall_at_10": rec,
        "search_s": search_s,
        "search_warm_s": wall, "search_warm_device_ms": dev_ms,
        "qps": B / wall,
        "memory_gb_total": {
            key: sum(t.nbytes()[key] for t in shards)
            for key in shards[0].nbytes()},
        "card": gpu, "device": str(dev), "torch": torch.__version__,
        "cuda": torch.version.cuda}
    Path(out_path).write_text(json.dumps(results, indent=2))
    print(json.dumps(results), flush=True)
    return results


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        device = resolve_device("cuda")
    except RuntimeError as e:
        log(f"dryrun_sharded_10m_torch: {e}")
        return 1
    run(int(os.environ.get("DRYRUN10M_N", 10_000_000)), device,
        ROOT / "BENCH_SHARDED_10M_TORCH.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
