"""scripts/bench_tiered_torch.py against scripts/bench_tiered.py (BASELINE
config 2) on the CPU, at 6,144 rows in batches of 4,096 with 16 queries:
one bulk build and one streamed batch of 2,048, a flush after each, the
wide beam active (6,144 rows >= its min_size 4,096).

scripts/bench_tiered.py fixes its 1,000 queries (a wide call at B = 1,000
takes about a minute on the CPU, and the sweep makes 30 of them), so the
test composes its JAX calls at the small sizes: StorageService +
IndexingService over the same memmap widths and config, the same
``embedding_like`` rows, the ingest loop and its flush test, the restart,
the exact truth, the ef sweep and the bf16 scan. The port's ``run`` does
the same on the CPU (the card's name stubbed; one timed call a row, times
are the card's).

Held: the flush count, the restart facts and every key of
BENCH_TIERED.json exactly (the keys by name, as chip_smoke.py holds them);
each ef's recall@10 within 0.02 of JAX's (the graph rows' tolerance; one id
in 160 is 0.00625), the bf16 scan's within 0.01; ``main`` without a card
exits 1 with nothing on stdout and leaves the committed file as it was.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

import chip_smoke
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.datasets import embedding_like
from vector_db_tpu.services.indexing_service import IndexingService
from vector_db_tpu.services.storage_service import StorageService
from vector_db_tpu.types import Node

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_tiered_torch as port  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, BATCH, Q, DIM, FLUSH, K = 6144, 4096, 16, 384, 1000, 10
GRAPH_TOL, SCAN_TOL = 0.02, 0.01


def _recall(ids, gt):
    ids, gt = np.asarray(ids), np.asarray(gt)
    return float(np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist()))
                          / K for i in range(len(gt))]))


def jax_run(work: Path) -> dict:
    """scripts/bench_tiered.py's steps at N, BATCH and Q queries on the
    CPU: {flushes, restart facts, recalls by ef, bf16 recall}."""
    cfg = {"embedding": {"model": "fake", "dimension": DIM},
           "device": "cpu",
           "index": {"M": 16, "ef_construction": 200,
                     "flush_threshold": FLUSH, "type": "hnsw",
                     "wide": {"enabled": True, "min_size": 4096}},
           "vector_db": {"file_path": str(work / "vdb"), "dimension": DIM,
                         "capacity": N + BATCH}}
    cfg_path = work / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    data = embedding_like(N + Q, DIM, 0)
    x, q = data[:N], data[N:]
    storage = StorageService(str(work / "vdb"), dim=DIM, capacity=N + BATCH)
    svc = IndexingService(storage=storage.storage, config_path=str(cfg_path))
    flushes = 0
    for s in range(0, N, BATCH):
        e = min(N, s + BATCH)
        svc.insert_nodes([Node(id=i, embedding=x[i],
                               metadata={"b": s // BATCH})
                          for i in range(s, e)])
        flushes += int(not svc._index_modified and e >= FLUSH)
    svc.force_save_index()
    storage2 = StorageService(str(work / "vdb"), dim=DIM,
                              capacity=N + BATCH)
    svc2 = IndexingService(storage=storage2.storage,
                           config_path=str(cfg_path))
    out = {"flushes": flushes, "loaded": svc2.is_index_loaded(),
           "storage": storage2.size(), "index": svc2.get_index_size()}
    index = svc2.index
    _, gt = index.search_batch_scan(q, K, mode="exact")
    svc2._maybe_enable_wide()
    out["ef"] = {ef: _recall(index.search_batch_wide(q, K, ef=ef)[1], gt)
                 for ef in port.EFS}
    out["bf16"] = _recall(index.search_batch_scan(q, K, mode="bf16")[1], gt)
    return out


@pytest.fixture(scope="module")
def both(one_torch_thread, tmp_path_factory):  # noqa: F811
    want = jax_run(tmp_path_factory.mktemp("jax_tiered"))
    out = tmp_path_factory.mktemp("tiered") / "out.json"
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "card", lambda: "rehearsal card, 700 W")
        mp.setattr(port, "B", Q)
        mp.setattr(port, "WARM", 0)
        mp.setattr(port, "REPS", 1)
        with contextlib.redirect_stdout(buf):
            got = port.run(N, "cpu", out, batch=BATCH)
    return got, want, out, buf.getvalue()


def test_flushes_and_restart_match_jax(both):
    got, want, _, _ = both
    assert got["ingest"]["flushes"] == want["flushes"] == 2
    assert want["loaded"] and want["storage"] == want["index"] == N
    assert got["resume"]["index_loaded"] is True
    assert got["resume"]["storage_size"] == N
    assert got["ingest"]["post_threshold_batches"] == 2
    assert len(got["ingest"]["batch_s"]) == 2


def test_sweep_recalls_match_jax(both):
    got, want, _, _ = both
    assert [r["ef"] for r in got["ef_sweep"]] == list(port.EFS)
    for row in got["ef_sweep"]:
        assert abs(row["recall"] - want["ef"][row["ef"]]) <= GRAPH_TOL, (
            row, want["ef"])
    assert abs(got["bf16_scan"]["recall"] - want["bf16"]) <= SCAN_TOL, (
        got["bf16_scan"], want["bf16"])


def test_keys_of_bench_tiered_json(both):
    got, _, out, printed = both
    jax_file = json.loads((ROOT / "BENCH_TIERED.json").read_text())
    have = {(p, k) for p, k, _ in chip_smoke._leaves(got)}
    missing = [(p, k) for p, k, _ in chip_smoke._leaves(jax_file)
               if (p, k) not in have]
    assert not missing, missing
    assert got["N"] == N and got["batch"] == BATCH and got["dim"] == DIM
    assert got["card"] == "rehearsal card, 700 W"
    assert [json.loads(line) for line in printed.strip().splitlines()] == [
        got]
    assert json.loads(out.read_text()) == got


def test_main_without_cuda_exits_1():
    path = ROOT / "BENCH_TIERED_TORCH.json"
    before = path.read_bytes() if path.exists() else None
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "bench_tiered_torch.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert res.stdout == ""
    assert "CUDA" in res.stderr
    assert (path.read_bytes() if path.exists() else None) == before
