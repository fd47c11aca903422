"""scripts/bench_api_torch.py on the CPU (``device="cpu"``) at 1,024
documents and 64 queries, its two services as child processes on ports the
OS hands out, beside the JAX package's app (vector_db_tpu.api.app's
``create_app`` in this process behind aiohttp's test server) on the same
documents.

scripts/bench_api.py fixes its ports and starts its children from the JAX
package, so the test composes the JAX side in-process: the JAX script's
config (fake-64, M 16, ef_construction 100, flush threshold 1,000,000, the
wide beam from 4,096 rows), the same documents drawn from
``default_rng(0)`` in the script's order, ingested through
``POST /embed/batch-docs`` in batches of 1,000, then the port's first 16
single ``POST /search`` queries. The fake embedder gives both packages the
same bits, so the exact top-10 over those embeddings (f32, numpy) is one
truth for both.

Held: every key of BENCH_API.json in the port's file (by name, as
chip_smoke.py holds them); ``/health`` at the document count; the filtered
search's hits all of its topic (the port's run raises otherwise); both
children ended; the recall@10 of the first 16 single searches against the
exact top-10 within 0.02 of the JAX app's (one id in 160 is 0.00625); the
indexing child reports each row's kernel launches through the script's
hook (none on the CPU); ``main``
without a card exits 1 with nothing on stdout and leaves the committed
file as it was.
"""

import asyncio
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
from aiohttp.test_utils import TestClient, TestServer

import chip_smoke
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.api.app import create_app
from vector_db_tpu_torch.embedding.fake import HashingEmbedder

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_api_torch as port  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DOCS, QUERIES, SINGLE, K = 1024, 64, 16, 10
TOL = 0.02


def documents(n):
    """The script's documents, drawn from default_rng(0) in its order."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        w = rng.choice(port.WORDS, size=6)
        out.append((f"doc {i}: " + " ".join(w),
                    {"topic": port.WORDS[i % len(port.WORDS)]}))
    return out


def jax_answers(tmp: Path, docs, queries):
    """The JAX app on ``docs`` through /embed/batch-docs: the ids of its
    /search answers to ``queries``."""
    cfg = {"embedding": {"model": f"fake-{port.DIM}",
                         "dimension": port.DIM},
           "device": "cpu",
           "index": {"ef_construction": 100, "M": 16,
                     "flush_threshold": 1_000_000,
                     "wide": {"dims": 0, "seeds": 2048, "frontier": 32,
                              "steps": 10, "min_size": 4096}},
           "vector_db": {"file_path": str(tmp / "data" / "vdb"),
                         "dimension": port.DIM, "capacity": DOCS + 1024}}
    path = tmp / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))

    async def go():
        client = TestClient(TestServer(create_app(config_path=str(path))))
        await client.start_server()
        try:
            for s in range(0, len(docs), port.INGEST_BATCH):
                part = docs[s:s + port.INGEST_BATCH]
                r = await client.post("/embed/batch-docs", json={
                    "contents": [c for c, _ in part],
                    "metadatas": [m for _, m in part]})
                assert r.status == 200, await r.text()
            out = []
            for q in queries:
                r = await client.post("/search", json={
                    "query": q, "top_k": K, "ef": 100})
                assert r.status == 200, await r.text()
                out.append([h["id"] for h in (await r.json())["results"]])
            return out
        finally:
            await client.close()

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_EMBEDDING_SERVICE", "false")
        mp.setenv("VDB_TPU_WARMUP", "0")
        return asyncio.run(go())


@pytest.fixture(scope="module")
def both(one_torch_thread, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("api") / "out.json"
    keep, buf = {}, io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "card", lambda: "rehearsal card, 700 W")
        with contextlib.redirect_stdout(buf):
            got = port.run(DOCS, "cpu", out, n_queries=QUERIES,
                           n_single=SINGLE, keep=keep)
    docs = documents(DOCS)
    queries = [q for q, _ in keep["answers"]]
    want = jax_answers(tmp_path_factory.mktemp("jax_api"), docs, queries)
    emb = HashingEmbedder(port.DIM)
    x = emb.embed_texts([c for c, _ in docs])
    qv = emb.embed_texts(queries)
    gt = np.argsort(((qv[:, None] - x[None]) ** 2).sum(-1), 1)[:, :K]
    return got, keep, want, gt, out, buf.getvalue()


def _recall(ids, gt):
    return float(np.mean([len(set(a) & set(b.tolist())) / K
                          for a, b in zip(ids, gt)]))


def test_single_search_recall_matches_jax(both):
    _, keep, want, gt, _, _ = both
    got_ids = [ids for _, ids in keep["answers"]]
    assert len(got_ids) == len(want) == SINGLE
    r_port, r_jax = _recall(got_ids, gt), _recall(want, gt)
    assert abs(r_port - r_jax) <= TOL, (r_port, r_jax)
    assert r_port >= 0.9, r_port


def test_health_filter_and_children(both):
    got, keep, _, _, _, _ = both
    assert got["health"]["index_size"] == got["health"]["storage_size"] \
        == DOCS
    assert got["search_filtered_ms"] > 0
    assert got["stats_devices"] == ["cpu"]
    assert len(keep["procs"]) == 2
    assert all(p.poll() is not None for p in keep["procs"])
    # the CPU runs each kernel's plain version: no launch
    for row in ("ingest", "search_single", "search_batch"):
        assert got[row]["launches"] == {}
    assert got["search_filtered_launches"] == {}


def test_keys_of_bench_api_json(both):
    got, _, _, _, out, printed = both
    jax_file = json.loads((ROOT / "BENCH_API.json").read_text())
    have = {(p, k) for p, k, _ in chip_smoke._leaves(got)}
    missing = [(p, k) for p, k, _ in chip_smoke._leaves(jax_file)
               if (p, k) not in have]
    assert not missing, missing
    assert got["n_docs"] == DOCS and got["device"] == "cpu"
    assert got["search_batch"]["n_queries"] == QUERIES
    assert got["card"] == "rehearsal card, 700 W"
    assert [json.loads(line) for line in printed.strip().splitlines()] == [
        got]
    assert json.loads(out.read_text()) == got


@pytest.mark.parametrize("fault", ["refused request", "dead child"])
def test_failed_request_fails_the_run(tmp_path, capsys, fault):
    """A request the indexing service refuses (a batch ingest with no
    contents: 422), or an embedding service that died (the indexing
    service's embed fails: 500), fails the run, prints both children's
    logs and ends both children; no result is written."""
    real = port.workload
    procs = []

    def bad(base, *args):
        import httpx

        kids = args[5]
        procs.extend(kids.procs.values())
        if fault == "dead child":
            kids.procs["embedding"].kill()
            kids.procs["embedding"].wait()
            return real(base, *args)
        port.ok(httpx.post(base + "/embed/batch-docs", json={}, timeout=60))
        return real(base, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "card", lambda: "rehearsal card, 700 W")
        mp.setattr(port, "workload", bad)
        with pytest.raises(RuntimeError,
                           match="422" if fault != "dead child" else "500"):
            port.run(8, "cpu", tmp_path / "out.json", n_queries=4,
                     n_single=1)
    err = capsys.readouterr().err
    assert "lines of the indexing service" in err
    assert "lines of the embedding service" in err
    assert len(procs) == 2 and all(p.poll() is not None for p in procs)
    assert not (tmp_path / "out.json").exists()


def test_main_without_cuda_exits_1():
    path = ROOT / "BENCH_API_TORCH.json"
    before = path.read_bytes() if path.exists() else None
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "bench_api_torch.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert res.stdout == ""
    assert "CUDA" in res.stderr
    assert (path.read_bytes() if path.exists() else None) == before
