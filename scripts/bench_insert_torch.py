#!/usr/bin/env python
"""Streaming-insert throughput on the PyTorch + CUDA port:
scripts/bench_insert.py's rows, sizes and seeds.

    python3 scripts/bench_insert_torch.py [grouped,sequential]

An HNSW(M=16, ef_construction=200, rng=Random(42), l_max=5) on the card,
bulk-built over the first 10,000 rows of ``embedding_like(., 384, seed 0)``;
then, for each edge-commit mode (``HNSW.commit_mode``; both by default, as
in the JAX script): one insert of 1 row, then at batch sizes 1024 and 4096
a "cold" and a "warm" ``insert_arrays(ids, rows, batch_size=bs)`` of the
next rows, each ending in a sync. "grouped" is the batch-parallel commit
(``commit_inserts_grouped``), "sequential" the item-at-a-time one
(``commit_inserts``, a host loop over the batch). Both take their
candidates from the level-0 scan on ``l2_topk`` (k = ef_construction).

Rows: ``{mode}_batch_{bs}_vps`` (the warm run's inserts a second, host
clock), ``corpus_after``; beside them the cold run's rate
(``{mode}_batch_{bs}_cold_vps``) and each run's kernels
(``{mode}_batch_{bs}_launches``, ``{mode}_batch_{bs}_cold_launches``).
Not carried over (relay workarounds): the compile cache. The cold run
stays: on the card it holds the allocator's and a first shape's costs, not
a compile.

Writes BENCH_INSERT_TORCH.json with the card's name and power limit, and
prints it as one JSON line. Runs on the card only: without one it prints no
result and exits 1. Progress goes to stderr.
"""

from __future__ import annotations

import random
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import (  # noqa: E402
    ROOT, card, cli, finish, header, launch_counts, launches_since, log)
from vector_db_tpu_torch.datasets import embedding_like  # noqa: E402
from vector_db_tpu_torch.index.hnsw import HNSW  # noqa: E402

DIM = 384
BASE = 10_000
BATCHES = (1024, 4096)
MODES = ("grouped", "sequential")
NOTE = ("warm rates; reference CPU insert: 66-139 vec/s. grouped = "
        "batch-parallel commit (sort/segment backlink merge), sequential = "
        "item-at-a-time host loop.")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(base: int, device, out_path, batches=BATCHES, modes=MODES,
        dim: int = DIM, keep: dict | None = None) -> dict:
    """The benchmark on ``device`` over ``base`` bulk-built rows. ``keep``
    (a dict) receives the grown index as ``hnsw``, the rows as ``x`` and
    the first streamed row as ``base``. Writes ``out_path``, prints the one
    result line and returns the results."""
    dev = torch.device(device)
    gpu = card()
    stream = 2 * sum(batches) * len(modes) + len(modes)
    x = embedding_like(base + stream, dim, 0)
    index = HNSW(M=16, ef_construction=200, rng=random.Random(42),
                 capacity=base + stream, l_max=5, device=dev)
    index.bulk_build(list(range(base)), x[:base])
    _sync(dev)
    log(f"bench_insert_torch on {dev} ({gpu}): base index {base}")

    results = {}
    offset = base
    for mode in modes:
        index.commit_mode = mode
        index.insert_arrays([offset], x[offset:offset + 1])
        _sync(dev)
        offset += 1
        for bs in batches:
            for phase in ("cold", "warm"):
                ids = list(range(offset, offset + bs))
                before = launch_counts()
                t0 = time.perf_counter()
                index.insert_arrays(ids, x[offset:offset + bs],
                                    batch_size=bs)
                _sync(dev)
                vps = bs / (time.perf_counter() - t0)
                offset += bs
                log(f"{mode} batch={bs}: {vps:.0f} vec/s {phase}")
                if phase == "warm":
                    results[f"{mode}_batch_{bs}_vps"] = vps
                    results[f"{mode}_batch_{bs}_launches"] = launches_since(
                        before)
                else:
                    results[f"{mode}_batch_{bs}_cold_vps"] = vps
                    results[f"{mode}_batch_{bs}_cold_launches"] = \
                        launches_since(before)

    results["corpus_after"] = index.size
    results["note"] = NOTE
    results.update(header(dev, gpu))
    if keep is not None:
        keep.update(hnsw=index, x=x, base=base)
    return finish(results, out_path)


def main() -> int:
    modes = tuple(sys.argv[1].split(",")) if len(sys.argv) > 1 else MODES
    return cli("bench_insert_torch", lambda dev: run(
        BASE, dev, ROOT / "BENCH_INSERT_TORCH.json", modes=modes))


if __name__ == "__main__":
    sys.exit(main())
