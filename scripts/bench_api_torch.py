#!/usr/bin/env python
"""End-to-end service benchmark on the PyTorch + CUDA port: the two aiohttp
services of the port as separate processes, driven over HTTP at 100,000
documents; scripts/bench_api.py's rows, sizes and seeds.

    python3 scripts/bench_api_torch.py

Env: BENCH_API_DOCS (100000), BENCH_API_QUERIES (2000),
BENCH_API_INGEST_BATCH (1000), BENCH_API_QBATCH (500).

The embedding service (``python -m vector_db_tpu_torch.api.embedding_app``)
and the indexing service (``python -m vector_db_tpu_torch.api.app`` with
``USE_EMBEDDING_SERVICE=true``) start from the repo root on ports the OS
hands out (``run`` takes fixed ones), so every embed crosses HTTP through
the embedding client, as in the reference's two-service deployment. The
config is the JAX script's (the deterministic fake-64 embedder, HNSW M 16,
ef_construction 100, flush threshold 1,000,000, the wide beam over the
full-dim mirror from 4,096 rows), with the index on the card; the
metadata memmap is at the reference's widths. Rows:

- ingest: the documents through ``POST /embed/batch-docs`` in batches;
- ``search_single``: 200 sequential ``POST /search`` (p50 / p90 / p99 ms,
  host clock, after one warm-up request);
- ``search_batch``: the queries through ``POST /search/batch`` in batches
  (after one warm-up batch);
- ``search_filtered_ms``: a ``/search`` under ``{"topic": "alpha"}``,
  whose hits must all carry that topic.

Beside them: ``GET /health`` after the ingest (its index size must be the
document count), the devices ``GET /stats`` names, and for each row the
kernels the indexing process launched, read before and after the row: a
``sitecustomize`` that the script puts first on the indexing child's
``PYTHONPATH`` makes the child write its ``launch_counts()`` to a file on
SIGUSR1 (then runs any other ``sitecustomize`` on that path). A request
that fails, an assertion, or a child that exits fails the run: the last
40 lines of both children's logs go to stderr. Both children
are terminated at the end, also on failure (SIGTERM to this process is
turned into an exception so that they are). Not carried over: the JAX
script's CPU default (the index runs on the card unless ``run`` is given
``device="cpu"``), its fixed ports 8300 / 8301 and its note on XLA
recompiles (the timeouts stay).

Writes BENCH_API_TORCH.json with the card's name and power limit, and
prints it as one JSON line. Runs on the card only: without one it prints no
result and exits 1. Progress goes to stderr.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import (  # noqa: E402
    ROOT, card, cli, env_int, finish, header, log)

N_DOCS, N_QUERIES, DIM = 100_000, 2000, 64
INGEST_BATCH, QBATCH, N_SINGLE = 1000, 500, 200
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lam", "mu"]
HEALTH_TIMEOUT = 600    # the indexing child allocates the metadata memmap
LOG_TAIL = 40
REPORT_TIMEOUT = 60

# The indexing child's sitecustomize: on SIGUSR1 it writes the kernel
# launches of its process to $KERNEL_LAUNCHES_FILE; then the next
# sitecustomize on the path, if any, runs as it would have.
CHILD_HOOK = '''\
import json
import os
import signal
import sys


def _report(*_):
    from vector_db_tpu_torch.ops.cuda import launch_counts

    path = os.environ["KERNEL_LAUNCHES_FILE"]
    with open(path + ".part", "w") as f:
        json.dump(launch_counts(), f)
    os.replace(path + ".part", path)


signal.signal(signal.SIGUSR1, _report)
_here = os.path.dirname(os.path.abspath(__file__))
_me, _path = sys.modules.pop("sitecustomize"), sys.path[:]
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or os.curdir) != _here]
try:
    import sitecustomize  # noqa: F401
except ImportError:
    sys.modules["sitecustomize"] = _me
finally:
    sys.path[:] = _path
'''


def free_port() -> int:
    """A port the OS has just handed out on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Children:
    """The two service processes and their logs."""

    def __init__(self, tmp: Path) -> None:
        self.tmp = tmp
        self.procs: dict = {}

    def start(self, name: str, module: str, env: dict) -> None:
        with open(self.tmp / f"{name}.log", "w") as out:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", module], env=env, cwd=ROOT,
                stdout=out, stderr=subprocess.STDOUT)

    def launches(self) -> dict:
        """The indexing child's kernel launches so far (SIGUSR1 asks its
        hook to write them)."""
        path = self.tmp / "launches.json"
        path.unlink(missing_ok=True)
        child = self.procs["indexing"]
        child.send_signal(signal.SIGUSR1)
        t0 = time.time()
        while not path.exists():
            if child.poll() is not None:
                raise RuntimeError(f"the indexing service exited with code "
                                   f"{child.returncode}")
            if time.time() - t0 > REPORT_TIMEOUT:
                raise RuntimeError("the indexing service did not report its "
                                   "kernel launches")
            time.sleep(0.01)
        return json.loads(path.read_text())

    def check(self) -> None:
        """Raise if a child has exited."""
        for name, p in self.procs.items():
            if p.poll() is not None:
                raise RuntimeError(f"the {name} service exited with code "
                                   f"{p.returncode}")

    def wait_health(self, url: str, timeout: float) -> dict:
        import httpx

        t0 = time.time()
        while time.time() - t0 < timeout:
            self.check()
            try:
                r = httpx.get(url + "/health", timeout=5)
                if r.status_code == 200:
                    return r.json()
            except httpx.HTTPError:
                pass
            time.sleep(0.5)
        raise RuntimeError(f"{url} never became healthy")

    def tails(self) -> str:
        out = []
        for name in self.procs:
            lines = (self.tmp / f"{name}.log").read_text(
                errors="replace").splitlines()
            out.append(f"--- last {LOG_TAIL} lines of the {name} service "
                       "---\n" + "\n".join(lines[-LOG_TAIL:]))
        return "\n".join(out)

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def ok(r):
    """The response, raising unless its status is 200."""
    if r.status_code != 200:
        raise RuntimeError(f"{r.request.method} {r.request.url.path}: "
                           f"{r.status_code} {r.text[:500]}")
    return r


def launches_between(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] > before[k]}


def workload(base: str, n_docs: int, n_queries: int, ingest_batch: int,
             qbatch: int, n_single: int, kids: Children, results: dict,
             answers: list) -> None:
    """scripts/bench_api.py's requests against the indexing service at
    ``base``; ``answers`` receives (query, ids) of each single search."""
    import httpx

    rng = np.random.default_rng(0)

    def doc(i):
        w = rng.choice(WORDS, size=6)
        return (f"doc {i}: " + " ".join(w), {"topic": WORDS[i % len(WORDS)]})

    long = httpx.Timeout(1800, connect=10)
    with httpx.Client(timeout=long) as client:
        before = kids.launches()
        t0 = time.perf_counter()
        for s in range(0, n_docs, ingest_batch):
            docs = [doc(i) for i in range(s, min(s + ingest_batch, n_docs))]
            ok(client.post(base + "/embed/batch-docs", json={
                "contents": [c for c, _ in docs],
                "metadatas": [m for _, m in docs]}))
            if (s // ingest_batch) % 10 == 0:
                el = time.perf_counter() - t0
                log(f"ingest {s + len(docs)}/{n_docs} "
                    f"({(s + len(docs)) / el:.0f} docs/s)")
        ingest_s = time.perf_counter() - t0
        after = kids.launches()
        results["ingest"] = {"seconds": ingest_s,
                             "docs_per_s": n_docs / ingest_s,
                             "batch": ingest_batch,
                             "launches": launches_between(before, after)}
        log(f"ingest: {n_docs / ingest_s:.0f} docs/s")
        kids.check()
        health = ok(client.get(base + "/health")).json()
        if health["index_size"] != n_docs or health["storage_size"] != n_docs:
            raise AssertionError(f"/health after the ingest: {health}")
        results["health"] = health
        # one warm-up request, outside the timed loop
        ok(client.post(base + "/search", json={"query": "warm", "top_k": 10,
                                               "ef": 100}))

    lat = []
    with httpx.Client(timeout=600) as client:
        before = kids.launches()
        for _ in range(n_single):
            q = {"query": f"doc {rng.integers(n_docs)}: alpha beta",
                 "top_k": 10, "ef": 100}
            t0 = time.perf_counter()
            r = client.post(base + "/search", json=q)
            lat.append((time.perf_counter() - t0) * 1e3)
            answers.append((q["query"],
                            [h["id"] for h in ok(r).json()["results"]]))
        after = kids.launches()
    lat.sort()
    results["search_single"] = {
        "p50_ms": statistics.median(lat),
        "p90_ms": lat[int(0.9 * len(lat))],
        "p99_ms": lat[int(0.99 * len(lat))],
        "qps_sequential": 1000.0 / statistics.median(lat),
        "launches": launches_between(before, after),
    }
    log(f"single search p50={results['search_single']['p50_ms']:.1f}ms")
    kids.check()

    queries = [f"doc {rng.integers(n_docs)}: " +
               " ".join(rng.choice(WORDS, size=4)) for _ in range(n_queries)]
    with httpx.Client(timeout=long) as client:
        ok(client.post(base + "/search/batch", json={
            "queries": queries[:qbatch], "top_k": 10, "ef": 100}))
    with httpx.Client(timeout=600) as client:
        before = kids.launches()
        t0 = time.perf_counter()
        for s in range(0, n_queries, qbatch):
            ok(client.post(base + "/search/batch", json={
                "queries": queries[s:s + qbatch], "top_k": 10, "ef": 100}))
        el = time.perf_counter() - t0
        after = kids.launches()
    results["search_batch"] = {"qps": n_queries / el, "batch": qbatch,
                               "n_queries": n_queries,
                               "launches": launches_between(before, after)}
    log(f"batch search: {n_queries / el:.0f} qps (batch={qbatch})")
    kids.check()

    with httpx.Client(timeout=600) as client:
        before = kids.launches()
        t0 = time.perf_counter()
        r = ok(client.post(base + "/search", json={
            "query": "doc 5: alpha", "top_k": 5,
            "metadata_filter": {"topic": "alpha"}}))
        results["search_filtered_ms"] = (time.perf_counter() - t0) * 1e3
        hits = r.json()["results"]
        if not hits or any(h["metadata"]["topic"] != "alpha" for h in hits):
            raise AssertionError(f"filtered search hits: {hits}")
        after = kids.launches()
        stats = ok(client.get(base + "/stats")).json()
    results["search_filtered_launches"] = launches_between(before, after)
    results["stats_devices"] = stats["device"]["devices"]
    kids.check()


def run(n_docs: int, device, out_path, n_queries: int = N_QUERIES,
        ingest_batch: int = INGEST_BATCH, qbatch: int = QBATCH,
        n_single: int = N_SINGLE, port: int = 0, emb_port: int = 0,
        keep: dict | None = None) -> dict:
    """The two services on ``port`` / ``emb_port`` (0: one the OS hands
    out), the index on ``device``, then the workload over ``n_docs``
    documents. ``keep`` (a dict) receives the single searches' (query,
    ids) as ``answers`` and the children as ``procs`` (ended by then).
    Writes ``out_path``, prints the one result line and returns the
    results."""
    dev = torch.device(device)
    gpu = card()
    if dev.type == "cuda":
        # the children load the kernels this build leaves under build/
        from vector_db_tpu_torch import _build

        _build.lib()
    results = {"n_docs": n_docs, "dim": DIM, **header(dev, gpu)}
    answers: list = []
    previous = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        with tempfile.TemporaryDirectory(prefix="bench_api_") as tmp:
            tmp = Path(tmp)
            (tmp / "data").mkdir()
            cfg = tmp / "config.yaml"
            cfg.write_text(f"""\
embedding: {{model: "fake-{DIM}", dimension: {DIM}}}
device: {dev.type}
index:
  ef_construction: 100
  M: 16
  flush_threshold: 1000000
  wide: {{dims: 0, seeds: 2048, frontier: 32, steps: 10, min_size: 4096}}
vector_db: {{file_path: {tmp}/data/vdb, dimension: {DIM}, capacity: {n_docs + 1024}}}
""")
            port, emb_port = port or free_port(), emb_port or free_port()
            env = dict(os.environ, CONFIG_PATH=str(cfg),
                       PYTHONUNBUFFERED="1")
            (tmp / "hook").mkdir()
            (tmp / "hook" / "sitecustomize.py").write_text(CHILD_HOOK)
            path = [str(tmp / "hook"), env.get("PYTHONPATH", "")]
            kids = Children(tmp)
            try:
                kids.start("embedding", "vector_db_tpu_torch.api.embedding_app",
                           dict(env, PORT=str(emb_port)))
                kids.wait_health(f"http://127.0.0.1:{emb_port}",
                                 HEALTH_TIMEOUT)
                kids.start("indexing", "vector_db_tpu_torch.api.app", dict(
                    env, PORT=str(port), USE_EMBEDDING_SERVICE="true",
                    EMBEDDING_SERVICE_URL=f"http://127.0.0.1:{emb_port}",
                    PYTHONPATH=os.pathsep.join(p for p in path if p),
                    KERNEL_LAUNCHES_FILE=str(tmp / "launches.json")))
                t0 = time.perf_counter()
                kids.wait_health(f"http://127.0.0.1:{port}", HEALTH_TIMEOUT)
                results["indexing_start_s"] = time.perf_counter() - t0
                log(f"bench_api_torch: services up on ports {emb_port} / "
                    f"{port}, index on {dev} ({gpu})")
                workload(f"http://127.0.0.1:{port}", n_docs, n_queries,
                         ingest_batch, qbatch, n_single, kids, results,
                         answers)
                if dev.type == "cuda" and not any(
                        torch.cuda.get_device_name(0) in d
                        for d in results["stats_devices"]):
                    raise AssertionError(f"/stats names "
                                         f"{results['stats_devices']}")
            except BaseException:
                log(kids.tails())
                raise
            finally:
                kids.stop()
    finally:
        signal.signal(signal.SIGTERM, previous)
    if keep is not None:
        keep.update(answers=answers, procs=list(kids.procs.values()))
    return finish(results, out_path)


def main() -> int:
    return cli("bench_api_torch", lambda dev: run(
        env_int("BENCH_API_DOCS", N_DOCS), dev,
        ROOT / "BENCH_API_TORCH.json",
        n_queries=env_int("BENCH_API_QUERIES", N_QUERIES),
        ingest_batch=env_int("BENCH_API_INGEST_BATCH", INGEST_BATCH),
        qbatch=env_int("BENCH_API_QBATCH", QBATCH)))


if __name__ == "__main__":
    sys.exit(main())
