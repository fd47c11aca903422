"""scripts/bench_sharded_torch.py against scripts/bench_sharded.py on the
CPU: the JAX sharded indexes on the 8 virtual CPU devices that
tests/conftest.py sets, the port on an 8-entry CPU mesh, at a flat index of
32,768 x 64 and an HNSW of 4,096 x 64 with 32 queries.

scripts/bench_sharded.py fixes its sizes (4M and 262,144 rows), so the
test composes its JAX calls at the small sizes, drawing from
``default_rng(0)`` in the script's order (flat rows, flat queries, graph
rows, graph queries, the 1,024 inserted rows, the filter set), so both
packages see the same rows. The port's ``run`` does the same on the CPU
(the card's name stubbed; times are the card's).

Held: the flat recall against the numpy brute force at 1.0 in both; the
HNSW recall at ef 120 and the 25 % filtered recall at ef 160 within 0.03 of
JAX's (one query's ten hits are 0.03125); the script's asserts (the four
inserted rows their own top-1, no deleted id back, every filtered hit in
the set) in both; every key of BENCH_SHARDED.json in the port's file;
``main`` without a card exits 1 with nothing on stdout and leaves the
committed file as it was.
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

import chip_smoke
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.parallel.mesh import make_mesh
from vector_db_tpu.parallel.sharded import ShardedFlatIndex, ShardedHNSW

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_sharded_torch as port  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_FLAT, N_HNSW, STEP = 32_768, 4096, 4096
TOL = 0.03


def jax_run() -> dict:
    """scripts/bench_sharded.py's sections at N_FLAT and N_HNSW rows."""
    mesh = make_mesh()
    rng = np.random.default_rng(0)
    dim, b, k = port.DIM, port.B, port.K
    x = rng.standard_normal((N_FLAT, dim)).astype(np.float32)
    q = rng.standard_normal((b, dim)).astype(np.float32)
    flat = ShardedFlatIndex(mesh=mesh, dim=dim,
                            capacity_per_shard=N_FLAT // 8)
    for s in range(0, N_FLAT, STEP):
        flat.insert(range(s, min(N_FLAT, s + STEP)), x[s:s + STEP])
    _, ids1 = flat.search_batch(q * (1 + 1e-6), k=k)
    out = {"flat": port._recall(np.asarray(ids1),
                                port.brute_force(x, q, k, STEP), k)}

    x2 = rng.standard_normal((N_HNSW, dim)).astype(np.float32)
    q2 = rng.standard_normal((port.Q_HNSW, dim)).astype(np.float32)
    idx = ShardedHNSW(M=12, ef_construction=80, mesh=mesh, dim=dim,
                      capacity_per_shard=N_HNSW // 8 + 1024)
    idx.bulk_build(range(N_HNSW), x2)
    d = (q2 * q2).sum(1)[:, None] - 2 * q2 @ x2.T + (x2 * x2).sum(1)[None, :]
    gt2 = np.argsort(d, axis=1)[:, :10]
    out["hnsw"] = port._recall(np.asarray(idx.search_batch(
        q2, k=10, ef=120)[1]), gt2, 10)
    extra = rng.standard_normal((port.N_EXTRA, dim)).astype(np.float32)
    idx.insert(range(N_HNSW, N_HNSW + port.N_EXTRA), extra)
    _, eids = idx.search_batch(extra[:4], k=1, ef=80)
    out["self_top1"] = list(np.asarray(eids)[:, 0])
    victims = list(range(0, 4096, 16))
    idx.delete_batch(victims)
    _, ids3 = idx.search_batch(x2[victims[:8]], k=5, ef=80)
    out["deleted_back"] = set(victims) & set(np.asarray(ids3).ravel().tolist())
    fset = set(int(i) for i in
               rng.choice(N_HNSW, size=N_HNSW // 4, replace=False))
    fset -= set(victims)
    _, fids = idx.search_batch(q2, k=10, ef=160, filter_ids=fset)
    fids = np.asarray(fids)
    alf = np.asarray(sorted(fset))
    df = ((q2[:, None] - x2[alf][None]) ** 2).sum(-1)
    gtf = alf[np.argsort(df, axis=1)[:, :10]]
    out["outside"] = [int(v) for row in fids for v in row
                      if v >= 0 and int(v) not in fset]
    out["filtered"] = port._recall(fids, gtf, 10)
    return out


@pytest.fixture(scope="module")
def both(one_torch_thread, tmp_path_factory):  # noqa: F811
    want = jax_run()
    out = tmp_path_factory.mktemp("sharded") / "out.json"
    keep, buf = {}, io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "card", lambda: "rehearsal card, 700 W")
        with contextlib.redirect_stdout(buf):
            got = port.run(N_FLAT, "cpu", out, n_hnsw=N_HNSW, step=STEP,
                           keep=keep)
    return got, want, keep, out, buf.getvalue()


def test_flat_recall_is_one_in_both(both):
    got, want, keep, _, _ = both
    assert got["flat_4m"]["recall_vs_bruteforce"] == want["flat"] == 1.0
    assert keep["flat"].n_shards == 8 and keep["flat"].cap == N_FLAT // 8
    assert got["mesh_devices"] == 8
    assert "8 shards on 1 device(s)" in got["platform"]


def test_hnsw_recalls_match_jax(both):
    got, want, _, _, _ = both
    h = got["hnsw_256k"]
    assert abs(h["recall_at_10_ef120"] - want["hnsw"]) <= TOL, (h, want)
    assert abs(h["filtered_recall_at_10_ef160"] - want["filtered"]) <= TOL, (
        h, want)


def test_script_asserts_hold_in_jax(both):
    """The port's run raises when one of them fails; JAX's hold too."""
    _, want, _, _, _ = both
    assert want["self_top1"] == [N_HNSW + i for i in range(4)]
    assert not want["deleted_back"] and not want["outside"]


def test_keys_of_bench_sharded_json(both):
    got, _, _, out, printed = both
    jax_file = json.loads((ROOT / "BENCH_SHARDED.json").read_text())
    have = {(p, k) for p, k, _ in chip_smoke._leaves(got)}
    missing = [(p, k) for p, k, _ in chip_smoke._leaves(jax_file)
               if (p, k) not in have]
    assert not missing, missing
    assert got["flat_4m"]["n"] == N_FLAT and got["hnsw_256k"]["n"] == N_HNSW
    assert got["card"] == "rehearsal card, 700 W"
    assert [json.loads(line) for line in printed.strip().splitlines()] == [
        got]
    assert json.loads(out.read_text()) == got


def test_main_without_cuda_exits_1():
    path = ROOT / "BENCH_SHARDED_TORCH.json"
    before = path.read_bytes() if path.exists() else None
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "bench_sharded_torch.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert res.stdout == ""
    assert "CUDA" in res.stderr
    assert (path.read_bytes() if path.exists() else None) == before
