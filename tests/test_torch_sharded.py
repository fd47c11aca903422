"""The port's sharded indexes (vector_db_tpu_torch/parallel) on eight CPU
shards, held to the contracts of tests/parallel/test_sharded.py and
against the JAX package's sharded indexes on its eight virtual devices
(tests/conftest.py), on the same numpy inputs.

Parity, beside each contract:
- ShardedFlatIndex and ShardedIVF (the JAX centroids carried over): ids
  equal to JAX's on every row (no ties in these corpora), distances within
  1e-5;
- ShardedHNSW: levels, routing and slots bit-equal; ``bulk_build`` tables
  equal to JAX's on a corpus without ties; search recall within 0.01 of
  JAX's; on JAX's saved npz, the port's classic ids equal JAX's on >= 99 %
  of the rows; the wide search on JAX's projection (eigenvector signs of
  two covariance sums may differ); a file saved by either package loads in
  the other;
- the sharded-hnsw service with ``make_mesh`` patched to eight CPU shards
  against the JAX service on eight virtual devices: the same answers after
  inserts, deletes, a threshold save and a restart; ``index.slices: 2``
  builds the 2-D mesh and answers the same.
"""

import numpy as np
import pytest
import torch
import yaml

from vector_db_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vector_db_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from vector_db_tpu.parallel.sharded import ShardedFlatIndex as JaxFlat
from vector_db_tpu.parallel.sharded import ShardedHNSW as JaxHNSW
from vector_db_tpu.parallel.sharded import ShardedIVF as JaxIVF
from vector_db_tpu_torch.parallel import mesh as mesh_mod
from vector_db_tpu_torch.parallel import sharded as sharded_mod
from vector_db_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from vector_db_tpu_torch.parallel.sharded import (
    ShardedFlatIndex,
    ShardedHNSW,
    ShardedIVF,
)
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU8 = ["cpu"] * 8
DIST_TOL = 1e-5


def mesh8():
    return make_mesh(devices=CPU8)


def brute_force(q, x, k):
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :k]


def recall(ids, want):
    k = want.shape[1]
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                          for a, b in zip(ids, want)]))


def same_answers(got, want):
    """Equal ids on every row, distances within 1e-5."""
    (dg, ig), (dw, iw) = got, want
    np.testing.assert_array_equal(ig, iw)
    np.testing.assert_allclose(dg, dw, rtol=DIST_TOL, atol=DIST_TOL)


# ---------------------------------------------------------------------------
# the contracts of tests/parallel/test_sharded.py
# ---------------------------------------------------------------------------

def test_mesh_has_8_devices():
    mesh = mesh8()
    assert mesh.size == 8 and mesh.shape == {"shard": 8}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError, match="Requested 9 devices"):
        make_mesh(9, devices=CPU8)


def test_sharded_flat_matches_brute_force(rng):
    idx = ShardedFlatIndex(mesh=mesh8(), dim=16, capacity_per_shard=64)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    idx.insert(list(range(300)), x)
    assert idx.size == 300

    q = rng.standard_normal((5, 16)).astype(np.float32)
    dists, ids = idx.search_batch(q, k=10)
    want = brute_force(q, x, 10)
    np.testing.assert_array_equal(ids, want)
    wd = np.sqrt(np.take_along_axis(
        ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1), want, axis=1))
    np.testing.assert_allclose(dists, wd, rtol=1e-3, atol=1e-3)
    # the JAX package's index on the same rows: ids and distances
    ref = JaxFlat(mesh=jax_make_mesh(), dim=16, capacity_per_shard=64)
    ref.insert(list(range(300)), x)
    same_answers((dists, ids), ref.search_batch(q, k=10))


def test_sharded_flat_delete(rng):
    idx = ShardedFlatIndex(mesh=mesh8(), dim=8, capacity_per_shard=16)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    idx.insert(list(range(40)), x)
    idx.delete(7)
    _, ids = idx.search_batch(x[7:8], k=5)
    assert 7 not in ids[0]


def test_sharded_flat_uneven_vs_devices(rng):
    # 3 vectors over 8 shards: most shards empty; must still work.
    idx = ShardedFlatIndex(mesh=mesh8(), dim=8, capacity_per_shard=4)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    idx.insert([10, 20, 30], x)
    dists, ids = idx.search_batch(x[1:2], k=3)
    assert ids[0][0] == 20
    assert dists[0][0] < 1e-3


def test_sharded_hnsw_recall(rng):
    idx = ShardedHNSW(M=8, ef_construction=50, mesh=mesh8(), dim=16,
                      capacity_per_shard=64)
    x = rng.standard_normal((320, 16)).astype(np.float32)
    # two streaming batches
    idx.insert(list(range(160)), x[:160])
    idx.insert(list(range(160, 320)), x[160:])
    assert idx.size == 320

    q = rng.standard_normal((10, 16)).astype(np.float32)
    dists, ids = idx.search_batch(q, k=5, ef=50)
    want = brute_force(q, x, 5)
    recalls = [len(set(ids[i]) & set(want[i])) / 5 for i in range(10)]
    # mirror the reference recall contract on the sharded path
    assert np.mean([r >= 0.7 for r in recalls]) >= 0.8


def test_sharded_hnsw_self_query(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=mesh8(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((100, 8)).astype(np.float32)
    idx.insert(list(range(100)), x)
    dists, ids = idx.search_batch(x[:4], k=1, ef=30)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2, 3])
    assert np.all(dists[:, 0] < 1e-3)


def test_sharded_hnsw_filter(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=mesh8(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((100, 8)).astype(np.float32)
    idx.insert(list(range(100)), x)
    allowed = set(range(0, 100, 2))
    dists, ids = idx.search_batch(x[:3], k=5, ef=30, filter_ids=allowed)
    live = ids[ids >= 0]
    assert len(live) > 0
    assert set(live.tolist()) <= allowed


def test_sharded_hnsw_bulk_build_recall(rng):
    idx = ShardedHNSW(M=8, ef_construction=50, mesh=mesh8(), dim=16,
                      capacity_per_shard=64)
    x = rng.standard_normal((320, 16)).astype(np.float32)
    idx.bulk_build(list(range(320)), x)
    assert idx.size == 320

    q = rng.standard_normal((10, 16)).astype(np.float32)
    dists, ids = idx.search_batch(q, k=5, ef=50)
    # exact-kNN edges: bulk graphs should beat the streaming-insert bar
    assert recall(ids, brute_force(q, x, 5)) >= 0.85


def test_sharded_hnsw_bulk_build_then_insert(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=mesh8(), dim=8,
                      capacity_per_shard=64)
    x = rng.standard_normal((120, 8)).astype(np.float32)
    idx.bulk_build(list(range(100)), x[:100])
    idx.insert(list(range(100, 120)), x[100:])
    assert idx.size == 120
    _, ids = idx.search_batch(x[105:108], k=1, ef=30)
    np.testing.assert_array_equal(ids[:, 0], [105, 106, 107])


def test_sharded_hnsw_bulk_build_duplicate_ids(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=mesh8(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    idx.bulk_build([1, 2, 1, 3, 2, 4], x)  # first occurrence wins
    assert idx.size == 4
    _, ids = idx.search_batch(x[:1], k=1, ef=20)
    assert ids[0, 0] == 1


def test_sharded_hnsw_delete_unlinks_edges(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=mesh8(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((100, 8)).astype(np.float32)
    idx.insert(list(range(100)), x)
    victims = [5, 17, 33]
    gslots = [idx._gslot_of_id[v] for v in victims]
    idx.delete_batch(victims)
    # no table row anywhere references a deleted slot
    neigh = idx.host_state()["neighbors"]
    for g in gslots:
        s, local = g // idx.cap, g % idx.cap
        shard_rows = neigh[s * idx.cap: (s + 1) * idx.cap]
        assert not np.any(shard_rows == local)
        assert np.all(neigh[g] == -1)
    # deleted ids never surface in results
    _, ids = idx.search_batch(x[victims], k=10, ef=40)
    assert not (set(victims) & set(ids.ravel().tolist()))
    # survivors still findable
    _, ids2 = idx.search_batch(x[50:52], k=1, ef=30)
    np.testing.assert_array_equal(ids2[:, 0], [50, 51])


def test_sharded_hnsw_delete_entry_reelection(rng):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=mesh8(), dim=8,
                      capacity_per_shard=32, seed=3)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    idx.insert(list(range(64)), x)
    # delete every entry node once; searches must keep working
    entries = idx.host_state()["entry"]
    victims = []
    for s, e in enumerate(entries):
        if e >= 0:
            nid = int(idx._id_of_gslot[s * idx.cap + int(e)])
            if nid >= 0:
                victims.append(nid)
    idx.delete_batch(victims)
    survivors = [i for i in range(64) if i not in set(victims)]
    _, ids = idx.search_batch(x[survivors[:3]], k=1, ef=30)
    np.testing.assert_array_equal(ids[:, 0], survivors[:3])
    # the re-elected entries are each shard's highest-level survivor
    state = idx.host_state()
    for s, e in enumerate(state["entry"]):
        lv = state["levels"][s * idx.cap: (s + 1) * idx.cap]
        assert e == (int(np.argmax(lv)) if lv.max() >= 0 else -1)


def test_reverse_merge_device_matches_host(rng):
    from vector_db_tpu_torch.index.hnsw import _reverse_merge
    from vector_db_tpu_torch.ops.graph_build import reverse_merge

    n, deg, width = 50, 4, 6
    fwd_d = rng.random((n, deg)).astype(np.float32)
    fwd_i = rng.integers(0, n, (n, deg)).astype(np.int32)
    fwd_i[fwd_i == np.arange(n)[:, None]] = -1  # no self edges
    order = np.argsort(fwd_d, axis=1)
    fwd_d = np.take_along_axis(fwd_d, order, axis=1)
    fwd_i = np.take_along_axis(fwd_i, order, axis=1)

    host = _reverse_merge(fwd_i, fwd_d, width)
    dev = reverse_merge(torch.from_numpy(fwd_d), torch.from_numpy(fwd_i),
                        width).numpy()
    for r in range(n):
        assert set(host[r][host[r] >= 0]) == set(dev[r][dev[r] >= 0])


def test_flat_2d_mesh_matches_bruteforce(rng):
    """2x4 ("slice", "shard") mesh: the hierarchical merge (within each
    slice, then only B·k pairs across slices) returns exact results, the
    same as the 1-D mesh's and JAX's."""
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    assert mesh.shape == {"slice": 2, "shard": 4}
    index = ShardedFlatIndex(mesh=mesh, dim=16, capacity_per_shard=64)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    index.insert(list(range(300)), x)

    q = rng.standard_normal((5, 16)).astype(np.float32)
    dists, ids = index.search_batch(q, k=7)
    d_all = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    want = np.argsort(d_all, axis=1)[:, :7]
    assert np.array_equal(np.sort(ids, axis=1), np.sort(want, axis=1))
    np.testing.assert_allclose(
        dists, np.sqrt(np.sort(d_all, axis=1)[:, :7]), rtol=1e-4, atol=1e-4)
    flat = ShardedFlatIndex(mesh=mesh8(), dim=16, capacity_per_shard=64)
    flat.insert(list(range(300)), x)
    same_answers((dists, ids), flat.search_batch(q, k=7))
    ref = JaxFlat(mesh=jax_make_mesh_2d(2, 4), dim=16, capacity_per_shard=64)
    ref.insert(list(range(300)), x)
    same_answers((dists, ids), ref.search_batch(q, k=7))
    with pytest.raises(ValueError, match="Requested 9 devices"):
        make_mesh_2d(3, 3, devices=CPU8)


def test_hnsw_2d_mesh_search_and_insert(rng):
    """ShardedHNSW on a 2x4 multi-slice mesh: insert + search end-to-end
    with per-axis merges."""
    mesh = make_mesh_2d(2, 4, devices=CPU8)
    index = ShardedHNSW(M=8, ef_construction=40, mesh=mesh, dim=16,
                        capacity_per_shard=64, l_max=3)
    x = rng.standard_normal((160, 16)).astype(np.float32)
    index.insert(list(range(160)), x)

    q = x[:8] + 0.01
    dists, ids = index.search_batch(q, k=5, ef=40)
    assert (ids[np.arange(8), 0] == np.arange(8)).mean() >= 0.9
    assert recall(ids, brute_force(q, x, 5)) >= 0.8


@pytest.fixture(scope="module")
def wide_pair():
    """(JAX ShardedHNSW, port ShardedHNSW) bulk-built from one 400 x 16
    corpus; the port built its own graph (the tables equal JAX's:
    test_bulk_build_tables_equal_jax)."""
    x = np.random.default_rng(5).standard_normal((400, 16)).astype(
        np.float32)
    ref = JaxHNSW(M=8, ef_construction=50, mesh=jax_make_mesh(), dim=16,
                  capacity_per_shard=128, l_max=4)
    ref.bulk_build(list(range(400)), x)
    port = ShardedHNSW(M=8, ef_construction=50, mesh=mesh8(), dim=16,
                       capacity_per_shard=128, l_max=4)
    port.bulk_build(list(range(400)), x)
    return ref, port, x


def test_sharded_wide_beam_recall(rng, wide_pair):
    """Wide-beam fan-out over the mesh: per-shard frontier search +
    hierarchical merge reaches brute-force-level recall, and the
    mesh-wide PCA path (covariances summed over shards) works end to end;
    recall within 0.01 of JAX's, the projected variant on JAX's
    projection."""
    ref, idx, x = wide_pair
    idx.enable_wide(dims=None, seeds=64)
    ref.enable_wide(dims=None, seeds=64)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    want = brute_force(q, x, 5)
    kw = dict(k=5, ef=64, frontier=16, steps=8)
    dists, ids = idx.search_batch_wide(q, **kw)
    rec = recall(ids, want)
    assert rec >= 0.85, rec
    assert rec >= recall(ref.search_batch_wide(q, **kw)[1], want) - 0.01
    # self-query through the projected variant (shared mesh-wide PCA)
    idx.enable_wide(dims=8, seeds=64)
    d2, i2 = idx.search_batch_wide(x[:4], k=1, ef=64, frontier=16, steps=8)
    assert list(i2[:, 0]) == [0, 1, 2, 3]
    # the projection is the covariance's top eigenvectors, up to sign
    ref.enable_wide(dims=8, seeds=64)
    jp = np.asarray(ref._wb_proj)
    np.testing.assert_allclose(np.abs((idx._wb_proj.numpy() * jp).sum(0)),
                               1.0, atol=1e-4)
    idx._wb_proj, idx._wb = torch.from_numpy(jp.copy()), None
    same = recall(idx.search_batch_wide(q, **kw)[1],
                  ref.search_batch_wide(q, **kw)[1])
    assert same >= 0.99, same
    # filtered fan-out: per-shard two-pool wide, subset contract + recall
    allowed = set(int(i) for i in rng.choice(400, size=100, replace=False))
    _, fi = idx.search_batch_wide(q, rerank_k=64, filter_ids=allowed, **kw)
    al = np.asarray(sorted(allowed))
    df = ((q[:, None] - x[al][None]) ** 2).sum(-1)
    want_f = al[np.argsort(df, 1)[:, :5]]
    assert all(int(v) in allowed for row in fi for v in row if v >= 0)
    rec_f = recall(fi, want_f)
    assert rec_f >= 0.8, rec_f
    _, jfi = ref.search_batch_wide(q, rerank_k=64, filter_ids=allowed, **kw)
    assert rec_f >= recall(jfi, want_f) - 0.01


def test_sharded_beam_recall(rng, wide_pair):
    """Pool-free beam fan-out over the mesh: per-shard merge-light
    traversal + hierarchical merge reaches brute-force-level recall,
    within 0.01 of JAX's."""
    ref, idx, x = wide_pair
    idx.enable_wide(dims=None, seeds=64)
    ref.enable_wide(dims=None, seeds=64)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    want = brute_force(q, x, 5)
    dists, ids = idx.search_batch_beam(q, k=5, frontier=16, steps=10)
    rec = recall(ids, want)
    assert rec >= 0.85, rec
    _, jids = ref.search_batch_beam(q, k=5, frontier=16, steps=10)
    assert rec >= recall(jids, want) - 0.01
    # filtered fan-out: trajectory mask per shard, subset contract
    allowed = set(int(i) for i in rng.choice(400, 120, replace=False))
    _, fi = idx.search_batch_beam(q, k=5, frontier=16, steps=10,
                                  rerank_k=128, filter_ids=allowed)
    assert all(int(v) in allowed for row in fi for v in row if v >= 0)
    al = np.asarray(sorted(allowed))
    df = ((q[:, None] - x[al][None]) ** 2).sum(-1)
    want_f = al[np.argsort(df, 1)[:, :5]]
    rec_f = recall(fi, want_f)
    assert rec_f >= 0.7, rec_f


def test_sharded_wide_merge_kernel(rng, wide_pair):
    """The sorted_topk pool merge (its plain version on the CPU) composes
    with the per-shard fan-out: recall parity with the plain merge."""
    _, idx, x = wide_pair
    idx.enable_wide(dims=None, seeds=64)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    d0, i0 = idx.search_batch_wide(q, k=5, ef=64, frontier=16, steps=8)
    d1, i1 = idx.search_batch_wide(q, k=5, ef=64, frontier=16, steps=8,
                                   merge_kernel=True)
    same = np.mean([len(set(i0[i]) & set(i1[i])) / 5 for i in range(8)])
    assert same >= 0.8, same


def _jax_centroids(monkeypatch, ref):
    """The port's ShardedIVF.build trains on the JAX index's centroids."""
    cents = torch.from_numpy(np.asarray(ref._centroids).copy())
    monkeypatch.setattr(sharded_mod, "kmeans",
                        lambda *a, **k: (cents, None))


def test_sharded_ivf_probe(rng, monkeypatch):
    idx = ShardedIVF(mesh=mesh8(), dim=16, capacity_per_shard=64,
                     k_cells=4)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    idx.build(list(range(300)), x)

    # probing EVERY cell = exact: must match brute force
    q = rng.standard_normal((5, 16)).astype(np.float32)
    _, ids = idx.search_batch(q, k=10, n_probe=4)
    np.testing.assert_array_equal(ids, brute_force(q, x, 10))

    # partial probe: self-query still lands in its own cell
    _, ids1 = idx.search_batch(x[:4], k=1, n_probe=1)
    np.testing.assert_array_equal(ids1[:, 0], [0, 1, 2, 3])

    # on JAX's centroids, every probe width answers as JAX does
    ref = JaxIVF(mesh=jax_make_mesh(), dim=16, capacity_per_shard=64,
                 k_cells=4)
    ref.build(list(range(300)), x)
    _jax_centroids(monkeypatch, ref)
    port = ShardedIVF(mesh=mesh8(), dim=16, capacity_per_shard=64,
                      k_cells=4)
    port.build(list(range(300)), x)
    for n_probe in (1, 2, 4):
        same_answers(port.search_batch(q, k=10, n_probe=n_probe),
                     ref.search_batch(q, k=10, n_probe=n_probe))

    # delete hides the row without a list rebuild
    idx.delete(3)
    _, ids2 = idx.search_batch(x[3:4], k=3, n_probe=4)
    assert 3 not in ids2[0]


def test_sharded_ivf_full_lists_drop_rows_as_jax(rng, monkeypatch):
    """A shard-cell list holds at most max_list rows: on JAX's centroids
    the port's lists equal JAX's, the rows past a full list left out of
    both, and ``cell_fill`` counts every row given to each shard-cell,
    the dropped ones too."""
    x = rng.standard_normal((300, 16)).astype(np.float32)
    ref = JaxIVF(mesh=jax_make_mesh(), dim=16, capacity_per_shard=64,
                 k_cells=4, max_list=4)
    ref.build(list(range(300)), x)
    _jax_centroids(monkeypatch, ref)
    port = ShardedIVF(mesh=mesh8(), dim=16, capacity_per_shard=64,
                      k_cells=4, max_list=4)
    port.build(list(range(300)), x)
    lists = np.stack([lst.numpy() for lst in port._lists])
    np.testing.assert_array_equal(
        lists, np.asarray(ref._lists).reshape(8, 4, 4))
    assert port.cell_fill.sum() == 300
    assert (lists >= 0).sum() == np.minimum(port.cell_fill, 4).sum() < 300


def test_sharded_hnsw_save_load_roundtrip(rng, tmp_path):
    """Sharded resume story (reference analog: storage.py:146-161 +
    hnsw.py pickle round-trip): save -> fresh mesh object -> load ->
    identical search results, and the loaded index keeps ingesting."""
    idx = ShardedHNSW(M=8, ef_construction=50, mesh=mesh8(), dim=16,
                      capacity_per_shard=64)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    idx.bulk_build(list(range(200)), x[:200])
    idx.insert(list(range(200, 300)), x[200:])  # mixed build paths
    idx.delete(17)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    d0, i0 = idx.search_batch(q, k=5, ef=50)

    path = tmp_path / "sharded.npz"
    idx.save_index(path)

    idx2 = ShardedHNSW(M=8, ef_construction=50, mesh=mesh8(), dim=16,
                       capacity_per_shard=64)
    idx2.load_index(path)
    assert idx2.size == idx.size
    d1, i1 = idx2.search_batch(q, k=5, ef=50)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-5, atol=1e-5)
    assert not np.any(i1 == 17)  # tombstone survives the round-trip

    # the resumed index accepts new inserts and routes around used slots
    idx2.insert([500], x[:1] + 0.001)
    _, ids = idx2.search_batch(x[:1], k=2, ef=50)
    assert set(ids[0].tolist()) == {0, 500}


def test_sharded_hnsw_load_rejects_mesh_mismatch(rng, tmp_path):
    idx = ShardedHNSW(M=4, ef_construction=30, mesh=mesh8(), dim=8,
                      capacity_per_shard=32)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    idx.bulk_build(list(range(40)), x)
    path = tmp_path / "s.npz"
    idx.save_index(path)
    other = ShardedHNSW(M=4, ef_construction=30, mesh=mesh8(), dim=8,
                        capacity_per_shard=16)  # different capacity
    with pytest.raises(ValueError, match="Mesh/capacity mismatch"):
        other.load_index(path)


# ---------------------------------------------------------------------------
# parity with the JAX package's ShardedHNSW
# ---------------------------------------------------------------------------

def _jax_state(ref):
    return {key: np.asarray(getattr(ref, f"_{key}")) for key in (
        "neighbors", "levels", "entry", "entry_level", "emb", "has_emb")}


def test_streamed_levels_routing_and_recall_match_jax(rng):
    """Streamed inserts (with duplicates across and within batches) draw
    the same levels into the same shards and slots as JAX's; the graphs
    (the port's grouped commit, JAX's item-at-a-time one) search at
    recall within 0.01 of JAX's."""
    x = rng.standard_normal((600, 16)).astype(np.float32)
    ref = JaxHNSW(M=8, ef_construction=40, mesh=jax_make_mesh(), dim=16,
                  capacity_per_shard=128)
    port = ShardedHNSW(M=8, ef_construction=40, mesh=mesh8(), dim=16,
                       capacity_per_shard=128)
    # 200 new ids a batch (the repeats are skipped): one JAX program shape
    batches = [list(range(0, 200)),
               list(range(150, 160)) + list(range(200, 400)) + [300, 301],
               list(range(400, 600))]
    for ids in batches:
        for idx in (ref, port):
            idx.insert(ids, x[ids])
    state, want = port.host_state(), _jax_state(ref)
    np.testing.assert_array_equal(state["levels"], want["levels"])
    np.testing.assert_array_equal(state["has_emb"], want["has_emb"])
    np.testing.assert_array_equal(state["emb"], want["emb"])
    np.testing.assert_array_equal(port._id_of_gslot, ref._id_of_gslot)
    assert port._next_in_shard == list(ref._next_in_shard)
    assert port._rr == ref._rr
    q = rng.standard_normal((40, 16)).astype(np.float32)
    truth = brute_force(q, x, 10)
    for ef in (20, 50):
        got = recall(port.search_batch(q, k=10, ef=ef)[1], truth)
        assert got >= recall(ref.search_batch(q, k=10, ef=ef)[1],
                             truth) - 0.01, ef


def test_bulk_build_tables_equal_jax(wide_pair):
    """bulk_build on a corpus without ties: every shard's neighbor table,
    levels, entry and routing equal JAX's."""
    ref, port, _ = wide_pair
    state, want = port.host_state(), _jax_state(ref)
    for key in want:
        np.testing.assert_array_equal(state[key], want[key], err_msg=key)
    np.testing.assert_array_equal(port._id_of_gslot, ref._id_of_gslot)
    assert port._rr == ref._rr


def test_files_load_across_packages_and_classic_ids_match(rng, tmp_path):
    """A file saved by either package loads in the other (the same npz
    keys); on JAX's graph the port's classic search returns JAX's ids on
    >= 99 % of the rows (filtered too), and after a delete_batch in both
    the tables stay equal."""
    x = rng.standard_normal((500, 16)).astype(np.float32)
    ref = JaxHNSW(M=8, ef_construction=40, mesh=jax_make_mesh(), dim=16,
                  capacity_per_shard=96)
    ref.bulk_build(list(range(400)), x[:400])
    ref.insert(list(range(400, 500)), x[400:])
    jax_file = tmp_path / "jax.npz"
    ref.save_index(jax_file)
    port = ShardedHNSW(M=8, ef_construction=40, mesh=mesh8(), dim=16,
                       capacity_per_shard=96)
    port.load_index(jax_file)
    assert port.size == ref.size == 500
    q = rng.standard_normal((64, 16)).astype(np.float32)
    allowed = set(range(0, 500, 3))
    for kw in (dict(ef=30), dict(ef=30, filter_ids=allowed)):
        (dg, ig), (dw, iw) = (port.search_batch(q, k=5, **kw),
                              ref.search_batch(q, k=5, **kw))
        rows = np.all(ig == iw, axis=1)
        assert rows.mean() >= 0.99, rows.mean()
        np.testing.assert_allclose(dg[rows], dw[rows], rtol=DIST_TOL,
                                   atol=DIST_TOL)
    victims = list(range(0, 500, 7))
    port.delete_batch(victims)
    ref.delete_batch(victims)
    state, want = port.host_state(), _jax_state(ref)
    for key in ("neighbors", "levels", "entry", "entry_level", "has_emb"):
        np.testing.assert_array_equal(state[key], want[key], err_msg=key)
    port_file = tmp_path / "port.npz"
    port.save_index(port_file)
    back = JaxHNSW(M=8, ef_construction=40, mesh=jax_make_mesh(), dim=16,
                   capacity_per_shard=96)
    back.load_index(port_file)
    assert back.size == port.size
    np.testing.assert_array_equal(back.search_batch(q, k=5, ef=30)[1],
                                  ref.search_batch(q, k=5, ef=30)[1])


# ---------------------------------------------------------------------------
# the sharded-hnsw service (no JAX test covers it)
# ---------------------------------------------------------------------------

def _service_pair(tmp_path, monkeypatch, **index):
    """(JAX service on its eight virtual devices, port service with
    make_mesh patched to eight CPU shards) on one config."""
    from vector_db_tpu.services.indexing_service import (
        IndexingService as JaxService)
    from vector_db_tpu.services.storage_service import (
        StorageService as JaxStorage)
    from vector_db_tpu_torch.services.indexing_service import IndexingService
    from vector_db_tpu_torch.services.storage_service import StorageService

    real = mesh_mod.make_mesh
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda n_devices=None,
                        devices=None: real(devices=CPU8))
    out = []
    for name, storage_cls, svc_cls in (("jax", JaxStorage, JaxService),
                                       ("port", StorageService,
                                        IndexingService)):
        cfg = {"embedding": {"model": "fake-16", "dimension": 16},
               "device": "cpu",
               "index": {"M": 8, "ef_construction": 40,
                         "flush_threshold": 300, "type": "sharded-hnsw",
                         **index},
               "vector_db": {"file_path": str(tmp_path / name / "vdb"),
                             "dimension": 16, "capacity": 2048}}
        (tmp_path / name).mkdir()
        path = tmp_path / name / "config.yaml"
        path.write_text(yaml.safe_dump(cfg))
        storage = storage_cls(str(tmp_path / name / "vdb"), dim=16,
                              capacity=2048)
        out.append((storage, lambda s=storage, c=str(path), cls=svc_cls:
                    cls(storage=s.storage, config_path=c)))
    return out


@pytest.mark.parametrize("slices", [1, 2])
def test_sharded_service_matches_jax_service(tmp_path, monkeypatch, rng,
                                             slices):
    from vector_db_tpu_torch.types import Node

    pair = _service_pair(tmp_path, monkeypatch, slices=slices)
    svcs = [make() for _, make in pair]
    assert svcs[1].index.n_shards == 8 and svcs[1].index.cap == 256
    assert len(svcs[1].index.mesh.axis_names) == slices
    x = rng.standard_normal((400, 16)).astype(np.float32)
    nodes = [Node(id=i, embedding=x[i], metadata={"par": i % 2})
             for i in range(400)]
    q = rng.standard_normal((24, 16)).astype(np.float32)
    allowed = {n.id for n in nodes if n.metadata["par"] == 0}

    def agree(svcs, filtered=True):
        """The batch route (filtered too) and the single-query route."""
        ji, pi = (svc.search_batch(q, k=5, ef=40) for svc in svcs)
        same_answers(pi, ji)
        js, ps = ([n.id for n, _ in svc.search(q[0], k=5, ef=40)]
                  for svc in svcs)
        assert ps == js == [int(v) for v in pi[1][0] if v >= 0]
        if filtered:
            jfi, pfi = (svc.search_batch(q, k=5, ef=40, filter_ids=allowed)
                        for svc in svcs)
            same_answers(pfi, jfi)
            assert set(pfi[1][pfi[1] >= 0].tolist()) <= allowed

    for (storage, _), svc in zip(pair, svcs):
        storage.save_many(nodes[:200])
        svc.insert_nodes(nodes[:200])           # below the threshold
    agree(svcs)
    if slices > 1:
        return
    for (storage, _), svc in zip(pair, svcs):
        storage.save_many(nodes[200:])
        svc.insert_nodes(nodes[200:])           # past it: a save
        for i in (3, 77, 301):
            svc.delete_node(i)
        svc.wait_for_flush()
        assert svc.index_file.exists() and svc.get_index_size() == 397
    agree(svcs)
    for svc in svcs:
        svc.force_save_index()
    restarted = [make() for _, make in pair]
    for svc in restarted:
        assert svc.is_index_loaded() and svc.get_index_size() == 397
    agree(restarted, filtered=False)
    ids = restarted[1].search_batch(x[[3, 77, 301]], k=5, ef=40)[1]
    assert not {3, 77, 301} & set(ids.ravel().tolist())
