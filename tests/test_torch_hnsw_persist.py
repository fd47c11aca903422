"""HNSW persistence on the port, held against the JAX package on the CPU.

- One file format: the split-adjacency npz saved by either package loads
  in the other with equal tables and equal search ids; the legacy dense
  ``neighbors`` key loads too.
- Trained state: the wide beam's projection and seed count round-trip;
  the PQ and RP arrays of a JAX file (modes the port does not run yet)
  are kept by a port load and written back by its next save, bit for bit.
- The contracts of tests/index/test_crash_resume.py and
  test_hnsw_mmap.py on the port's ``MMapNodeStorage``, whose files are
  also the JAX package's.
"""

import random

import numpy as np
import pytest

from vector_db_tpu.index.hnsw import HNSW as JaxHNSW
from vector_db_tpu.storage import InMemoryNodeStorage as JaxMemory
from vector_db_tpu.storage.mmap import MMapNodeStorage as JaxMMap
from vector_db_tpu.types import Node as JaxNode
from vector_db_tpu_torch.index.hnsw import HNSW
from vector_db_tpu_torch.storage import InMemoryNodeStorage, MMapNodeStorage
from vector_db_tpu_torch.types import Node

N, DIM, M, L_MAX = 700, 16, 8, 4


def _data(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, DIM)).astype(np.float32),
            rng.standard_normal((20, DIM)).astype(np.float32))


def _storage(cls, node_cls, x, skip=()):
    st = cls()
    for i in range(len(x)):
        if i not in skip:
            st.save(node_cls(id=i, embedding=x[i], metadata={"i": i}))
    return st


def _built(cls, x, path, **kw):
    """An index holding x: bulk-built rows, then two streamed batches and
    two deletes."""
    node_cls = Node if cls is HNSW else JaxNode
    storage = _storage(InMemoryNodeStorage if cls is HNSW else JaxMemory,
                       node_cls, x)
    idx = cls(M=M, ef_construction=40, rng=random.Random(4),
              storage=storage, index_file=path, l_max=L_MAX, **kw)
    idx.bulk_build(range(500), x[:500])
    idx.insert_arrays(range(500, 600), x[500:600])
    idx.insert_nodes([node_cls(id=i, embedding=x[i]) for i in range(600, N)])
    for victim in (7, 550):
        idx.delete_node(victim)
    return idx


def _state(idx):
    g = idx.graph
    return (np.asarray(g.neighbors.cpu() if hasattr(g.neighbors, "cpu")
                       else g.neighbors),
            np.asarray(g.levels.cpu() if hasattr(g.levels, "cpu")
                       else g.levels),
            int(g.entry), int(g.entry_level),
            np.asarray(idx._store.export_id_map()))


def _assert_same_state(a, b):
    for u, v in zip(_state(a), _state(b)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_file_loads_in_the_other_package(tmp_path, saver):
    x, q = _data()
    path = tmp_path / "g.npz"
    src_cls, dst_cls = (JaxHNSW, HNSW) if saver == "jax" else (HNSW, JaxHNSW)
    src = _built(src_cls, x, path, **({"device": "cpu"}
                                      if src_cls is HNSW else {}))
    src.save_index()
    with np.load(path) as z:
        assert {"neighbors0", "neighbors_up", "upper_slots", "levels",
                "entry", "entry_level", "id_of_slot", "M", "ef_construction",
                "l_max"} <= set(z.files) and "neighbors" not in z.files
    kw = {"device": "cpu"} if dst_cls is HNSW else {}
    store = _storage(InMemoryNodeStorage if dst_cls is HNSW else JaxMemory,
                     Node if dst_cls is HNSW else JaxNode, x, skip=(7, 550))
    dst = dst_cls(M=4, ef_construction=10, rng=random.Random(0),
                  storage=store, index_file=path, **kw)
    assert (dst.M, dst.ef_construction, dst.l_max) == (M, 40, L_MAX)
    assert dst.size == N - 2 and dst.recover_unlinked() == 0
    _assert_same_state(dst, src)
    np.testing.assert_array_equal(
        np.asarray(dst.search_batch(q, 10, ef=64)[1]),
        np.asarray(src.search_batch(q, 10, ef=64)[1]))


def test_port_save_load_roundtrip_and_keeps_inserting(tmp_path):
    x, q = _data(5)
    path = tmp_path / "g.npz"
    idx = _built(HNSW, x, path, device="cpu")
    assert HNSW(M=M, ef_construction=40, rng=random.Random(0),
                device="cpu").snapshot_for_save() is None   # no index file
    idx.save_index()
    assert not (tmp_path / "g.npz.tmp.npz").exists()
    again = HNSW(M=M, ef_construction=40, rng=random.Random(4),
                 storage=idx.storage, index_file=path, device="cpu")
    _assert_same_state(again, idx)
    np.testing.assert_array_equal(again._levels_host, idx._levels_host)
    d0, i0 = idx.search_batch(q, 5, ef=40)
    d1, i1 = again.search_batch(q, 5, ef=40)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    # the reloaded index takes new inserts into its live graph
    new = np.random.default_rng(1).standard_normal((30, DIM)).astype(
        np.float32)
    again.insert_nodes([Node(id=1000 + i, embedding=new[i])
                        for i in range(30)])
    assert again.size == N - 2 + 30
    _, ids = again.search_batch(new, 1, ef=40)
    assert (ids[:, 0] == 1000 + np.arange(30)).mean() >= 0.9


def test_legacy_dense_neighbors_key_loads(tmp_path):
    x, q = _data(6)
    ref = _built(JaxHNSW, x, tmp_path / "unused.npz")
    neighbors, levels, entry, entry_level, ids = _state(ref)
    path = tmp_path / "dense.npz"
    np.savez(path, neighbors=neighbors, levels=levels,
             entry=np.int32(entry), entry_level=np.int32(entry_level),
             id_of_slot=ids, M=M, ef_construction=40, l_max=L_MAX)
    port = HNSW(M=4, ef_construction=10, rng=random.Random(0),
                storage=_storage(InMemoryNodeStorage, Node, x,
                                 skip=(7, 550)),
                index_file=path, device="cpu")
    _assert_same_state(port, ref)
    np.testing.assert_array_equal(
        port.search_batch(q, 10, ef=64)[1],
        np.asarray(ref.search_batch(q, 10, ef=64)[1]))


def test_wide_state_roundtrips(tmp_path):
    x, q = _data(7)
    path = tmp_path / "g.npz"
    idx = _built(HNSW, x, path, device="cpu")
    idx.enable_wide(dims=8, seeds=64)
    _, want = idx.search_batch_wide(q, 5, ef=64, frontier=16, steps=8)
    idx.save_index()
    again = HNSW(M=M, ef_construction=40, rng=random.Random(0),
                 storage=idx.storage, index_file=path, device="cpu")
    np.testing.assert_array_equal(again._wb_proj.numpy(),
                                  idx._wb_proj.numpy())
    assert again._wb_n_seeds == 64
    _, got = again.search_batch_wide(q, 5, ef=64, frontier=16, steps=8)
    np.testing.assert_array_equal(got, want)
    # and JAX reads the port's wide state
    ref = JaxHNSW(M=M, ef_construction=40, rng=random.Random(0),
                  storage=_storage(JaxMemory, JaxNode, x, skip=(7, 550)),
                  index_file=path)
    np.testing.assert_array_equal(np.asarray(ref._wb_proj),
                                  idx._wb_proj.numpy())
    assert ref._wb_n_seeds == 64


def test_pq_and_rp_arrays_are_carried_through(tmp_path):
    """A JAX file with trained PQ (OPQ rotation) and RP state: the port
    loads it into live PQ and RP state (both searches answer), saves, and
    JAX reloads the port's file with the arrays bit for bit."""
    x, q = _data(8)
    path = tmp_path / "g.npz"
    ref = _built(JaxHNSW, x, path)
    ref.enable_pq(chunks=4, ksub=16, opq_iters=1)
    ref.enable_rp(dims=8)
    ref.save_index()
    with np.load(path) as z:
        want = {k: z[k].copy() for k in ("pq_codebooks", "pq_rotation",
                                         "rp_proj")}
    port = HNSW(M=M, ef_construction=40, rng=random.Random(0),
                storage=_storage(InMemoryNodeStorage, Node, x,
                                 skip=(7, 550)),
                index_file=path, device="cpu")
    for call in (port.search_batch_pq, port.search_batch_rp):
        d, ids = call(q, 5, ef=32)
        assert ids.shape == (20, 5) and (ids >= 0).all()
        assert not np.isin(ids, [7, 550]).any()
    port.insert_arrays([5000], x[:1] + 0.5)
    path.unlink()
    port.save_index()
    with np.load(path) as z:
        for k, v in want.items():
            np.testing.assert_array_equal(z[k], v)
    back = JaxHNSW(M=M, ef_construction=40, rng=random.Random(0),
                   storage=_storage(JaxMemory, JaxNode, x, skip=(7, 550)),
                   index_file=path)
    np.testing.assert_array_equal(np.asarray(back._pq.codebooks),
                                  want["pq_codebooks"])
    np.testing.assert_array_equal(np.asarray(back._rp_proj), want["rp_proj"])
    assert back.search_batch_pq(q, 5, ef=32)[1].shape == (20, 5)


# -- tests/index/test_crash_resume.py and test_hnsw_mmap.py, on the port -----
def _mmap(tmp_path, dim=16, capacity=256):
    return dict(embedding_file=tmp_path / "e.npy",
                metadata_file=tmp_path / "m.npy", dim=dim, capacity=capacity)


def _nodes(rng, ids, dim=16):
    return [Node(id=i, embedding=rng.standard_normal(dim).astype(np.float32),
                 metadata={"i": i}, content=f"doc-{i}") for i in ids]


def _open(storage, tmp_path):
    return HNSW(M=8, ef_construction=40, rng=random.Random(0),
                storage=storage, index_file=tmp_path / "g.npz",
                device="cpu")


def test_kill_between_storage_and_graph_commit(tmp_path):
    rng = np.random.default_rng(42)
    kwargs = _mmap(tmp_path)
    storage = MMapNodeStorage(**kwargs)
    index = HNSW(M=8, ef_construction=40, rng=random.Random(42),
                 storage=storage, index_file=tmp_path / "g.npz",
                 device="cpu")
    index.build_index(_nodes(rng, range(40)))
    index.save_index()
    torn = _nodes(rng, range(40, 48))
    storage.save_many(torn)    # the storage half of a batch, then a crash
    storage.close()

    index2 = _open(MMapNodeStorage(**kwargs), tmp_path)
    assert index2.size == 48
    for node in torn:
        hit = index2.search(np.asarray(node.embedding), k=1, ef=64)[0]
        assert hit[0].id == node.id and hit[1] < 0.05
    _, ids = index2.search_batch(
        np.stack([np.asarray(n.embedding) for n in torn]), 48, ef=96)
    for row in ids:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    assert index2.recover_unlinked() == 0


def test_recover_is_idempotent_and_clean_resume_noop(tmp_path):
    rng = np.random.default_rng(42)
    kwargs = _mmap(tmp_path)
    storage = MMapNodeStorage(**kwargs)
    index = HNSW(M=8, ef_construction=40, rng=random.Random(42),
                 storage=storage, index_file=tmp_path / "g.npz",
                 device="cpu")
    index.build_index(_nodes(rng, range(30)))
    index.save_index()
    storage.close()
    index2 = _open(MMapNodeStorage(**kwargs), tmp_path)
    assert index2.recover_unlinked() == 0 and index2.size == 30


def test_recover_skips_deleted_rows(tmp_path):
    rng = np.random.default_rng(42)
    kwargs = _mmap(tmp_path)
    storage = MMapNodeStorage(**kwargs)
    index = HNSW(M=8, ef_construction=40, rng=random.Random(42),
                 storage=storage, index_file=tmp_path / "g.npz",
                 device="cpu")
    nodes = _nodes(rng, range(30))
    index.build_index(nodes)
    index.delete_node(7)
    index.save_index()
    storage.close()
    index2 = _open(MMapNodeStorage(**kwargs), tmp_path)
    assert index2.size == 29
    assert all(n.id != 7 for n, _ in index2.search(
        np.asarray(nodes[7].embedding), k=10, ef=64))


def test_hnsw_mmap_backed_reload(tmp_path):
    rng = np.random.default_rng(42)
    kwargs = _mmap(tmp_path, capacity=128)
    storage = MMapNodeStorage(**kwargs)
    index = HNSW(M=8, ef_construction=40, rng=random.Random(42),
                 storage=storage, index_file=tmp_path / "g.npz",
                 device="cpu")
    nodes = _nodes(rng, range(60))
    index.build_index(nodes)
    index.delete_node(17)
    index.save_index()
    q = rng.standard_normal(16).astype(np.float32)
    before = [(n.id, round(d, 4)) for n, d in index.search(q, k=5, ef=40)]
    storage.close()

    index2 = _open(MMapNodeStorage(**kwargs), tmp_path)
    assert index2.size == 59
    assert [(n.id, round(d, 4))
            for n, d in index2.search(q, k=5, ef=40)] == before
    node = index2.search(nodes[3].embedding, k=1, ef=40)[0][0]
    assert (node.id, node.content, node.metadata) == (3, "doc-3", {"i": 3})
    assert all(n.id != 17 for n, _ in index2.search(
        nodes[17].embedding, k=10, ef=40))
    index2.insert_node(Node(id=100, embedding=rng.standard_normal(16).astype(
        np.float32)))
    assert index2.size == 60


def test_mmap_storage_files_are_the_jax_packages(tmp_path):
    """The port's MMapNodeStorage and the JAX package's read each other's
    files: rows, payloads, deletes and bulk reads agree."""
    rng = np.random.default_rng(2)
    kwargs = _mmap(tmp_path, dim=8, capacity=64)
    port = MMapNodeStorage(**kwargs)
    port.save_many(_nodes(rng, range(20), dim=8))
    port.save(Node(id=40, embedding=np.ones(8, np.float32),
                   metadata={"k": "v"}, content="x" * 20000))
    port.delete(3)
    assert sorted(port.get_all_ids()) == sorted(set(range(20)) - {3} | {40})
    port.close()
    ref = JaxMMap(**kwargs)
    port = MMapNodeStorage(**kwargs)
    ids = [0, 3, 40, 99]
    (a, fa), (b, fb) = port.get_embeddings(ids), ref.get_embeddings(ids)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fa, [True, False, True, False])
    np.testing.assert_array_equal(fa, fb)
    assert port.get(40).content == ref.get(40).content == "x" * 10240
    assert port.get(40).metadata == {"k": "v"}
    assert port.size() == ref.size() == 20
    assert port.get_next_id() == ref.get_next_id() == 41
    np.testing.assert_array_equal(port.live_rows(), ref.live_rows())
    with pytest.raises(KeyError):
        port.get_embedding(3)
    ref.close()
    port.close()
