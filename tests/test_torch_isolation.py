"""vector_db_tpu_torch runs without jax and without any module of the JAX
package vector_db_tpu (FlatIndex, IVF-PQ and HNSW end to end), and never
falls back to the CPU when a GPU was asked for."""

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
        # HNSW end to end: bulk build through insert_nodes, delete, the
        # classic beam (filtered too) and the wide beam with the merge
        # kernel's plain version
        import random
        xe = vt.embedding_like(4096, 16, seed=0, intrinsic=8)
        h = vt.HNSW(M=8, ef_construction=50, rng=random.Random(0),
                    device="cpu")
        h.insert_nodes([vt.Node(id=i, embedding=xe[i]) for i in range(4096)])
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
        print("isolated")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        assert FlatIndex().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FlatIndex()
