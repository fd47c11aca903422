"""scripts/bench_insert_torch.py against scripts/bench_insert.py on the CPU,
at a 1,024-row base and batches of 64 and 128, in both commit modes.

scripts/bench_insert.py fixes its base (10,000 rows) and batches (1,024 and
4,096), so the test composes its JAX calls at the small sizes: the same
HNSW (M 16, ef_construction 200, Random(42), l_max 5) bulk-built over the
same ``embedding_like`` rows, then per mode one 1-row insert and a cold and
a warm ``insert_arrays`` at each batch size. The port's ``run`` does the
same on the CPU (the card's name stubbed; times are the card's).

Held: ``corpus_after`` in both packages; every row name of
BENCH_INSERT.json (at the small batch sizes) in the port's file; every
streamed row its own top-1 (classic beam) in both graphs; the grown graph's
recall@10 against the exact top-10 within 0.02 of JAX's (one id in 640 is
0.0016); ``main`` without a card exits 1 with nothing on stdout and leaves
the committed file as it was.
"""

import contextlib
import io
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.index.hnsw import HNSW

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_insert_torch as port  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE, BATCHES, Q, K, EF = 1024, (64, 128), 64, 10, 64
TOL = 0.02


def _recall(ids, gt):
    return float(np.mean([len(set(np.asarray(a).tolist()) & set(b.tolist()))
                          / K for a, b in zip(ids, gt)]))


def jax_run(x):
    """scripts/bench_insert.py's calls at BASE and BATCHES: the index."""
    index = HNSW(M=16, ef_construction=200, rng=random.Random(42),
                 capacity=x.shape[0], l_max=5)
    index.bulk_build(list(range(BASE)), x[:BASE])
    offset = BASE
    for mode in port.MODES:
        index.commit_mode = mode
        index.insert_arrays([offset], x[offset:offset + 1])
        offset += 1
        for bs in BATCHES:
            for _ in ("cold", "warm"):
                index.insert_arrays(list(range(offset, offset + bs)),
                                    x[offset:offset + bs], batch_size=bs)
                offset += bs
    return index


@pytest.fixture(scope="module")
def both(one_torch_thread, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("insert") / "out.json"
    keep, buf = {}, io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "card", lambda: "rehearsal card, 700 W")
        with contextlib.redirect_stdout(buf):
            got = port.run(BASE, "cpu", out, batches=BATCHES, keep=keep)
    x = keep["x"]
    ref = jax_run(x)
    rng = np.random.default_rng(3)
    q = (x[rng.choice(x.shape[0], Q, replace=False)]
         + 0.05 * rng.standard_normal((Q, x.shape[1]))).astype(np.float32)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), 1)[:, :K]
    return got, keep["hnsw"], ref, x, q, gt, out, buf.getvalue()


def test_corpus_after_and_row_names(both):
    got, idx, ref, x, _, _, out, printed = both
    stream = 2 * sum(BATCHES) * len(port.MODES) + len(port.MODES)
    assert got["corpus_after"] == BASE + stream == idx.size == ref.size
    assert x.shape[0] == BASE + stream
    jax_file = json.loads((ROOT / "BENCH_INSERT.json").read_text())
    want = set(json.loads(json.dumps(jax_file).replace(
        "_1024_", f"_{BATCHES[0]}_").replace("_4096_", f"_{BATCHES[1]}_")))
    assert want <= set(got)
    assert {f"{m}_batch_{bs}_vps" for m in port.MODES
            for bs in BATCHES} <= set(got)
    assert got["card"] == "rehearsal card, 700 W"
    assert [json.loads(line) for line in printed.strip().splitlines()] == [
        got]
    assert json.loads(out.read_text()) == got


def test_every_streamed_row_is_its_own_top1_in_both(both):
    _, idx, ref, x, _, _, _, _ = both
    rows = np.arange(BASE, x.shape[0])
    for index in (idx, ref):
        ids = np.asarray(index.search_batch(x[rows], 1, ef=EF)[1])
        assert np.array_equal(ids[:, 0], rows), (
            type(index).__module__, int((ids[:, 0] != rows).sum()))


def test_grown_graph_recall_matches_jax(both):
    _, idx, ref, _, q, gt, _, _ = both
    r_port = _recall(idx.search_batch(q, K, ef=EF)[1], gt)
    r_ref = _recall(np.asarray(ref.search_batch(q, K, ef=EF)[1]), gt)
    assert abs(r_port - r_ref) <= TOL, (r_port, r_ref)
    assert r_port >= 0.9, r_port


def test_smoke_check_inserted_on_the_grown_graph(both):
    """phase 11's check of the streamed rows, on the port's grown graph."""
    _, idx, _, x, _, _, _, _ = both
    sample = np.linspace(BASE, x.shape[0] - 1, 100).astype(np.int64)
    no_in, own = chip_smoke.check_inserted(torch, idx, x, BASE, x.shape[0],
                                           sample, say=lambda m: None)
    assert own == 1.0 and no_in <= 0.01 * (x.shape[0] - BASE)


def test_main_without_cuda_exits_1():
    path = ROOT / "BENCH_INSERT_TORCH.json"
    before = path.read_bytes() if path.exists() else None
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "bench_insert_torch.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert res.stdout == ""
    assert "CUDA" in res.stderr
    assert (path.read_bytes() if path.exists() else None) == before
