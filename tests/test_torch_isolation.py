"""vector_db_tpu_torch runs without jax and without any module of the JAX
package vector_db_tpu (FlatIndex, IVF-PQ, HNSW end to end with inserts and
persistence, the serving layer: StorageService, IndexingService with
autotune and sharded-hnsw, and the app factory; the sharded indexes; the
headline benchmark bench_torch.py; the 10M scripts
scripts/bench_10m_torch.py and scripts/dryrun_sharded_10m_torch.py; the
benchmark scripts of BASELINE configs 3 and 4,
scripts/bench_{sift,pq,1m,latency}_torch.py; the last four drivers,
scripts/bench_{insert,tiered,sharded,api}_torch.py, and the API's two
service processes), and never falls back to the CPU when a GPU was asked
for."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from vector_db_tpu_torch.index.flat import FlatIndex

ROOT = Path(__file__).resolve().parent.parent


def test_port_never_imports_jax():
    script = textwrap.dedent("""
        import sys

        import numpy as np
        import torch

        import vector_db_tpu_torch as vt

        # one CPU thread: beside parallel test workers a thread per core
        # oversubscribes the cores
        torch.set_num_threads(1)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((300, 16)).astype(np.float32)
        for precision in ("f32", "bf16", "blocksel", "blocksel2p"):
            idx = vt.FlatIndex(device="cpu", precision=precision,
                               bf16_guard="off")
            idx.insert_nodes([vt.Node(id=i, embedding=x[i])
                              for i in range(300)])
            _, ids = idx.search_batch(x[:3], 4)
            assert (ids[:, 0] == [0, 1, 2]).all(), (precision, ids)
        # IVF-PQ end to end: scale build, residual PQ with OPQ, add,
        # delete, filtered and unfiltered probes, and a PQCodec scan
        xs, qs = vt.sift_like(3000, dim=16, seed=0, queries=4,
                              n_clusters=32)
        ivf = vt.IvfIndex(k=16, device="cpu")
        ivf.build_arrays(range(3000), xs, seed=0, iters=5, spill=1)
        ivf.enable_pq(chunks=4, ksub=32, opq_iters=1)
        ivf.add(vt.Node(id=5000, embedding=qs[0]))
        ivf.delete(7)
        _, ids = ivf.search_batch(qs, n_probe=4, top_k=5, pq=True)
        assert ids[0, 0] == 5000 and 7 not in ids, ids
        _, ids = ivf.search_batch(qs, n_probe=4, top_k=5,
                                  filter_ids=set(range(0, 3000, 2)))
        assert (ids % 2 == 0).all(), ids
        codec = vt.PQCodec(k=16, chunks=4, dim=16, device="cpu")
        codec.train(xs[:500], iters=5, restarts=1)
        _, rows = codec.adc_search(xs[:3], codec.encode(xs[:500]), top_k=3)
        assert rows.shape == (3, 3), rows
        # HNSW end to end: bulk build, streaming inserts, delete, the
        # classic beam (filtered too), the wide beam with the merge
        # kernel's plain version, and a save and reload over memmap storage
        import random
        import tempfile
        from pathlib import Path
        from vector_db_tpu_torch.storage import MMapNodeStorage
        xe = vt.embedding_like(4096, 16, seed=0, intrinsic=8)
        h = vt.HNSW(M=8, ef_construction=50, rng=random.Random(0),
                    device="cpu")
        h.bulk_build(range(3072), xe[:3072])
        h.insert_nodes([vt.Node(id=i, embedding=xe[i])
                        for i in range(3072, 4096)])
        h.delete_node(1)
        _, ids = h.search_batch(xe[:3], 4, ef=32)
        assert ids[0, 0] == 0 and ids[2, 0] == 2 and 1 not in ids, ids
        _, ids = h.search_batch(xe[:3], 4, ef=32,
                                filter_ids=set(range(0, 4096, 2)))
        assert (ids % 2 == 0).all(), ids
        h.enable_wide(dims=8, seeds=256)
        _, ids = h.search_batch_wide(xe[:3], 4, ef=64, frontier=16, steps=6,
                                     merge_kernel=True)
        assert ids[0, 0] == 0 and 1 not in ids, ids
        with tempfile.TemporaryDirectory() as tmp:
            st = MMapNodeStorage(Path(tmp) / "e.npy", Path(tmp) / "m.npy",
                                 dim=16, capacity=4096)
            st.save_many([vt.Node(id=i, embedding=xe[i])
                          for i in range(4096) if i != 1])
            h.storage, h.index_file = st, Path(tmp) / "g.npz"
            h.save_index()
            h2 = vt.HNSW(M=8, ef_construction=50, rng=random.Random(0),
                         storage=st, index_file=h.index_file, device="cpu")
            assert h2.size == 4095 and h2.recover_unlinked() == 0
            assert (h2.search_batch(xe[:3], 4, ef=32)[1]
                    == h.search_batch(xe[:3], 4, ef=32)[1]).all()
            st.close()
        # the serving layer: the indexing service loads neither httpx nor
        # aiohttp; a config-driven service over StorageService, then the
        # app factory and a request through it
        import asyncio
        import os
        import yaml
        import vector_db_tpu_torch.services.indexing_service as isvc
        from vector_db_tpu_torch.services import StorageService
        assert "httpx" not in sys.modules and "aiohttp" not in sys.modules
        with tempfile.TemporaryDirectory() as tmp:
            cfg = Path(tmp) / "c.yaml"
            cfg.write_text(yaml.safe_dump({
                "embedding": {"model": "fake-16", "dimension": 16},
                "device": "cpu",
                "index": {"M": 4, "ef_construction": 30,
                          "flush_threshold": 8, "scan_batch_threshold": 4,
                          "wide": {"dims": 0, "seeds": 32, "min_size": 16}},
                "vector_db": {"file_path": str(Path(tmp) / "vdb"),
                              "dimension": 16, "capacity": 256}}))
            st = StorageService(str(Path(tmp) / "vdb"), dim=16, capacity=256)
            svc = isvc.IndexingService(storage=st.storage,
                                       config_path=str(cfg))
            nodes = [vt.Node(id=i, embedding=xe[i], metadata={"g": i % 2})
                     for i in range(64)]
            st.save_many(nodes)
            svc.insert_nodes(nodes)
            svc.wait_for_flush()
            _, ids = svc.search_batch(xe[:4], 3)
            assert (ids[:, 0] == [0, 1, 2, 3]).all(), ids
            assert svc.search(xe[5], 3, filter_ids=st.filter_by_metadata(
                {"g": 1}))[0][0].id == 5
            from aiohttp.test_utils import TestClient, TestServer
            from vector_db_tpu_torch.api.app import create_app
            from vector_db_tpu_torch.services import EmbeddingService

            async def drive():
                client = TestClient(TestServer(create_app(
                    config_path=str(cfg),
                    embedding_client=EmbeddingService(str(cfg)),
                    storage_service=st, indexing_service=svc)))
                await client.start_server()
                r = await client.post("/embed", json={"content": "one"})
                assert r.status == 200
                r = await client.post("/search", json={"query": "one",
                                                       "top_k": 1})
                body = await r.json()
                assert body["results"][0]["content"] == "one", body
                await client.close()

            os.environ["VDB_TPU_WARMUP"] = "0"   # keep stdout to one line
            asyncio.run(drive())
        # calibrated routing (services/autotune.py) and the sharded-hnsw
        # service, then the sharded indexes on four CPU shards
        svcs = []
        with tempfile.TemporaryDirectory() as tmp:
            for i, index in enumerate((
                    {"autotune": {"sample": 8, "k": 3, "ef_ladder": [64],
                                  "min_size": 16}},
                    {"type": "sharded-hnsw"})):
                cfg = Path(tmp) / f"c{i}.yaml"
                cfg.write_text(yaml.safe_dump({
                    "embedding": {"model": "fake-16", "dimension": 16},
                    "device": "cpu",
                    "index": {"M": 4, "ef_construction": 30,
                              "flush_threshold": 8, **index},
                    "vector_db": {"file_path": str(Path(tmp) / f"v{i}"),
                                  "dimension": 16, "capacity": 256}}))
                st = StorageService(str(Path(tmp) / f"v{i}"), dim=16,
                                    capacity=256)
                svc = isvc.IndexingService(storage=st.storage,
                                           config_path=str(cfg))
                st.save_many(nodes)
                svc.insert_nodes(nodes)
                assert svc.search(xe[3], 2)[0][0].id == 3
                svcs.append(svc)
        assert list(svcs[0]._autotune.stats()) == ["b8@0.95"]
        assert svcs[1].index.n_shards == 1
        mesh = vt.make_mesh(devices=["cpu"] * 4)
        sh = vt.ShardedHNSW(M=4, ef_construction=30, mesh=mesh, dim=16,
                            capacity_per_shard=64)
        sh.bulk_build(range(100), xe[:100])
        sh.insert(range(100, 120), xe[100:120])
        sh.delete(5)
        _, ids = sh.search_batch(xe[100:103], 2, ef=30)
        assert (ids[:, 0] == [100, 101, 102]).all(), ids
        sf = vt.ShardedIVF(mesh=vt.make_mesh_2d(2, 2, devices=["cpu"] * 4),
                           dim=16, capacity_per_shard=64, k_cells=4)
        sf.build(range(120), xe[:120])
        assert (sf.search_batch(xe[:3], 2, n_probe=4)[1][:, 0]
                == [0, 1, 2]).all()
        assert "jax" not in sys.modules, sorted(
            m for m in sys.modules if m.startswith("jax"))
        jax_pkg = sorted(m for m in sys.modules
                         if m == "vector_db_tpu"
                         or m.startswith("vector_db_tpu."))
        assert not jax_pkg, jax_pkg
        if not torch.cuda.is_available():
            try:
                vt.FlatIndex(device="cuda")
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise AssertionError("FlatIndex(device='cuda') ran without a GPU")
            try:
                vt.IvfIndex(k=4, device="cuda")
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise AssertionError("IvfIndex(device='cuda') ran without a GPU")
            try:
                vt.HNSW(M=8, ef_construction=50, rng=random.Random(0),
                        device="cuda")
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise AssertionError("HNSW(device='cuda') ran without a GPU")
            for make in (vt.make_mesh, vt.ShardedFlatIndex, vt.ShardedHNSW):
                try:
                    make()
                except RuntimeError as e:
                    assert "CUDA" in str(e)
                else:
                    raise AssertionError(f"{make.__name__}() ran without "
                                         "a GPU")
        print("isolated")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


def test_bench_torch_never_imports_jax():
    """bench_torch.py imported and run end to end at a tiny size on the CPU
    (the card's name stubbed) loads no jax and no module of the JAX
    package."""
    script = textwrap.dedent("""
        import json
        import sys
        import tempfile
        from pathlib import Path

        import torch

        import bench_torch

        torch.set_num_threads(1)
        bench_torch.card = lambda: "isolation rehearsal"
        with tempfile.TemporaryDirectory() as tmp:
            details = bench_torch.run(
                hnsw_n=600, headline_n=1024, ref_n=500, n_q=4, device="cpu",
                cache_path=Path(tmp) / "none.json",
                details_path=Path(tmp) / "details.json")
        assert details["headline_1M_768"]["exact_f32"]["recall"] == 1.0
        assert "jax" not in sys.modules, sorted(
            m for m in sys.modules if m.startswith("jax"))
        jax_pkg = sorted(m for m in sys.modules
                         if m == "vector_db_tpu"
                         or m.startswith("vector_db_tpu."))
        assert not jax_pkg, jax_pkg
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout)
    assert "isolation rehearsal" in line["metric"]


def test_10m_scripts_never_import_jax():
    """scripts/bench_10m_torch.py and scripts/dryrun_sharded_10m_torch.py
    imported and run end to end at a tiny size on the CPU (the card's name
    stubbed, chunks and query counts cut) load no jax and no module of the
    JAX package."""
    script = textwrap.dedent("""
        import sys
        import tempfile
        from pathlib import Path

        import torch

        sys.path.insert(0, "scripts")
        import bench_10m_torch as one
        import dryrun_sharded_10m_torch as sh

        torch.set_num_threads(1)
        one.card = lambda: "isolation rehearsal"
        one.CHUNK, one.B, one.LATENCY_REPS = 4096, 20, 2
        sh.CHUNK, sh.B, sh.BLOCKS_K = 256, 4, 2
        with tempfile.TemporaryDirectory() as tmp:
            a = one.run(9000, "cpu", Path(tmp) / "a.json")
            b = sh.run(9000, "cpu", Path(tmp) / "b.json")
        assert a["card"] == b["card"] == "isolation rehearsal"
        assert "jax" not in sys.modules, sorted(
            m for m in sys.modules if m.startswith("jax"))
        jax_pkg = sorted(m for m in sys.modules
                         if m == "vector_db_tpu"
                         or m.startswith("vector_db_tpu."))
        assert not jax_pkg, jax_pkg
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [line["N"] for line in lines] == [9000, 9000]


def test_config_3_4_scripts_never_import_jax():
    """scripts/bench_sift_torch.py, bench_pq_torch.py, bench_1m_torch.py
    and bench_latency_torch.py imported and run end to end at a tiny size
    on the CPU (the card's name stubbed, 8 queries, one timed call a row,
    the codecs trained for 2 iterations, the 1M script's scan and IVF
    sections) load no jax and no module of the JAX package."""
    script = textwrap.dedent("""
        import sys
        import tempfile
        from pathlib import Path

        import torch

        sys.path.insert(0, "scripts")
        import bench_1m_torch as b1m
        import bench_common_torch as common
        import bench_latency_torch as lat
        import bench_pq_torch as bpq
        import bench_sift_torch as sift
        from vector_db_tpu_torch.datasets import embedding_like, sift_like
        from vector_db_tpu_torch.index.pq import PQCodec

        torch.set_num_threads(1)
        for m in (sift, bpq, b1m, lat):
            m.card = lambda: "isolation rehearsal"
        common.WARM, common.REPS = 0, 1
        sift.B = bpq.B = 8
        train = PQCodec.train
        PQCodec.train = lambda self, x, seed=0, iters=100, restarts=4, \\
            opq_iters=0, opq_sample=65536: train(self, x, seed, 2, 1,
                                                 min(opq_iters, 1))
        xs, qs = sift_like(1200, dim=128, seed=0, queries=8)
        xe = embedding_like(608, 768, 0)
        src = {"x": xs, "q": qs}
        with tempfile.TemporaryDirectory() as tmp:
            keep = {}
            out = [sift.run(1200, "cpu", Path(tmp) / "s.json", source=src,
                            k_cells=16, keep=keep),
                   bpq.run(1200, "cpu", Path(tmp) / "p.json", source=src),
                   b1m.run(600, "cpu", Path(tmp) / "m.json",
                           source={"x": xe[:600], "q": xe[600:]}, b=8,
                           k_cells=16, sections="scan,scan3p,scan2p,ivf")]
            out.append(lat.run(600, "cpu", Path(tmp) / "l.json",
                               sift={"ivf": keep["ivf"], "q": qs},
                               graph_source={"x": xe[:600],
                                             "q": xe[600:]},
                               batches=(1, 8), reps=1))
        assert {o["card"] for o in out} == {"isolation rehearsal"}
        assert "jax" not in sys.modules, sorted(
            m for m in sys.modules if m.startswith("jax"))
        jax_pkg = sorted(m for m in sys.modules
                         if m == "vector_db_tpu"
                         or m.startswith("vector_db_tpu."))
        assert not jax_pkg, jax_pkg
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [line["N"] for line in lines] == [1200, 1200, 600, 1200]


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        assert FlatIndex().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FlatIndex()


CHILD_MODULES = '''
import atexit
import os
import sys


def _report():
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "vector_db_tpu" or m.startswith("vector_db_tpu."))
    out = os.path.join(os.environ["ISOLATION_OUT"], f"{os.getpid()}.txt")
    with open(out, "w") as f:
        f.write(" ".join([sys.argv[0]] + bad))


atexit.register(_report)
'''


def test_tail_driver_scripts_never_import_jax(tmp_path):
    """scripts/bench_insert_torch.py, bench_tiered_torch.py,
    bench_sharded_torch.py and bench_api_torch.py imported and run end to
    end at a tiny size on the CPU (the card's name stubbed) load no jax and
    no module of the JAX package; nor do the API's two children
    (``python -m vector_db_tpu_torch.api.embedding_app`` and ``.app``),
    each of which reports its modules at exit through a sitecustomize on
    its path."""
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sitecustomize.py").write_text(CHILD_MODULES)
    (tmp_path / "out").mkdir()
    script = textwrap.dedent("""
        import os
        import sys
        import tempfile
        from pathlib import Path

        import torch

        sys.path.insert(0, "scripts")
        import bench_api_torch as api
        import bench_insert_torch as ins
        import bench_sharded_torch as shard
        import bench_tiered_torch as tier

        torch.set_num_threads(1)
        for m in (api, ins, shard, tier):
            m.card = lambda: "isolation rehearsal"
        tier.B, tier.WARM, tier.REPS = 8, 0, 1
        with tempfile.TemporaryDirectory() as tmp:
            out = [ins.run(256, "cpu", Path(tmp) / "i.json",
                           batches=(16, 32)),
                   tier.run(4200, "cpu", Path(tmp) / "t.json", batch=4100,
                            efs=(50,)),
                   shard.run(8192, "cpu", Path(tmp) / "s.json", n_hnsw=2048,
                             step=4096)]
            os.environ["PYTHONPATH"] = os.pathsep.join(
                [sys.argv[1], os.getcwd()])
            os.environ["ISOLATION_OUT"] = sys.argv[2]
            out.append(api.run(64, "cpu", Path(tmp) / "a.json", n_queries=8,
                               n_single=2))
        assert {o["card"] for o in out} == {"isolation rehearsal"}
        assert "jax" not in sys.modules, sorted(
            m for m in sys.modules if m.startswith("jax"))
        jax_pkg = sorted(m for m in sys.modules
                         if m == "vector_db_tpu"
                         or m.startswith("vector_db_tpu."))
        assert not jax_pkg, jax_pkg
    """)
    out = subprocess.run([sys.executable, "-c", script,
                          str(tmp_path / "site"), str(tmp_path / "out")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [line.get("n_docs", line.get("N")) for line in lines] == [
        None, 4200, None, 64]
    reports = sorted(p.read_text().split()
                     for p in (tmp_path / "out").glob("*.txt"))
    assert [r[0].rsplit("/", 1)[-1] for r in reports] == [
        "app.py", "embedding_app.py"], reports
    assert all(len(r) == 1 for r in reports), reports
