"""The ported IvfIndex, end to end on the CPU, against the JAX IvfIndex.

A JAX-built index (centroids, lists, PQ codebooks, OPQ rotation, codes and
residual scalars) is carried over with ``load_state``, after which both
packages must answer ``search_batch`` alike in the flat and PQ-probe modes:
residual and not, filtered, after ``add`` and after ``delete``. The npz
index file loads in either direction. A port-built index meets the JAX
tests' recall floors. Reranked distances are exact f32 L2 (rtol = atol =
1e-5); un-reranked ADC estimates carry the coarse-term cancellation of the
residual identity (atol 1e-3). Ids are equal wherever distances are apart.
The JAX side scores with ``adc="gather"``, its f32 reference formulation.
"""

import numpy as np
import pytest

from tests.torch_parity import assert_topk_parity, recall
from vector_db_tpu.index.ivf import IvfIndex as JaxIvf
from vector_db_tpu.storage import InMemoryNodeStorage
from vector_db_tpu.types import Node
from vector_db_tpu_torch.index.ivf import IvfIndex


def _nodes(x, start=0):
    return [Node(id=start + i, embedding=x[i]) for i in range(x.shape[0])]


def _data(seed, rows=600, dim=32, b=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, dim)).astype(np.float32)
    return rng, x, rng.standard_normal((b, dim)).astype(np.float32)


def _jax_index(x, k=16, **pq):
    ref = JaxIvf(k=k)
    ref.build_index(_nodes(x))
    if pq:
        ref.enable_pq(**pq)
    return ref


def _carry(ref):
    """The port holding the JAX index's state (and sharing its storage)."""
    port = IvfIndex(k=ref.k, storage=ref.storage, device="cpu")
    kw = {}
    if getattr(ref, "_pq", None) is not None:
        rot = ref._pq.rotation
        kw = dict(codebooks=np.asarray(ref._pq.codebooks),
                  rotation=None if rot is None else np.asarray(rot),
                  residual=ref._pq_residual, codes=ref._codes_np,
                  sx=ref._sx_np)
    port.load_state(np.asarray(ref._store.emb), np.asarray(ref._store.valid),
                    ref._store.export_id_map(), ref.centroids,
                    ref.inverted_lists, spill=getattr(ref, "_spill", 1), **kw)
    return port


def _check(port, ref, q, adc="pallas", atol=1e-5, **kw):
    d_got, i_got = port.search_batch(q, adc=adc, **kw)
    d_want, i_want = ref.search_batch(q, adc="gather", **kw)
    assert d_got.dtype == np.float32 and i_got.dtype == np.int64
    assert_topk_parity(d_got, i_got, d_want, i_want, atol=atol)
    return i_got


PQ_CONFIGS = [dict(chunks=8, ksub=32, residual=True),
              dict(chunks=8, ksub=32, residual=False),
              dict(chunks=4, ksub=16, residual=True, opq_iters=2)]


@pytest.mark.parametrize("pq", PQ_CONFIGS)
def test_carried_index_matches_jax(pq):
    _, x, q = _data(0)
    ref = _jax_index(x, **pq)
    port = _carry(ref)
    assert port.get_cluster_stats() == ref.get_cluster_stats()
    assert port.size == ref.size == 600
    _check(port, ref, q, n_probe=4, top_k=10)                  # flat
    for adc in ("pallas", "onehot8", "gather"):
        _check(port, ref, q, adc=adc, n_probe=4, top_k=10, pq=True)
    _check(port, ref, q, n_probe=5, top_k=7, pq=True, fetch=20)
    _check(port, ref, q, n_probe=4, top_k=10, pq=True, rerank=False,
           atol=1e-3)


@pytest.mark.parametrize("pq", [True, False])
def test_filter_matches_jax(pq):
    rng, x, q = _data(1)
    ref = _jax_index(x, chunks=8, ksub=32)
    port = _carry(ref)
    allowed = set(int(i) for i in rng.choice(600, 150, replace=False))
    ids = _check(port, ref, q, n_probe=6, top_k=5, pq=pq,
                 filter_ids=allowed, fetch=128)
    assert set(ids[ids >= 0].tolist()) <= allowed


def test_add_and_delete_match_jax():
    rng, x, q = _data(2)
    ref = _jax_index(x, chunks=8, ksub=32, opq_iters=2)
    port = _carry(ref)
    fresh = rng.standard_normal((3, 32)).astype(np.float32)
    gone = [int(i) for i in rng.choice(600, 20, replace=False)]
    for idx in (port, ref):
        for nd in _nodes(fresh, start=1000):
            idx.add(nd)
        for i in gone:
            idx.delete(i)
    np.testing.assert_array_equal(port._codes_np, ref._codes_np)
    np.testing.assert_allclose(port._sx_np, ref._sx_np, rtol=1e-4, atol=1e-4)
    for pq in (False, True):
        ids = _check(port, ref, q, n_probe=4, top_k=10, pq=pq)
        assert not set(ids.ravel().tolist()) & set(gone)
        _, own = port.search_batch(fresh, n_probe=4, top_k=1, pq=pq)
        np.testing.assert_array_equal(own[:, 0], [1000, 1001, 1002])
    assert port.get_cluster_stats() == ref.get_cluster_stats()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_index_round_trips_between_packages(tmp_path, writer):
    _, x, q = _data(3)
    storage = InMemoryNodeStorage()
    path = tmp_path / "ivf.index.npz"
    make = {"jax": lambda: JaxIvf(k=8, storage=storage, index_file=path),
            "port": lambda: IvfIndex(k=8, storage=storage, index_file=path,
                                     device="cpu")}
    src = make[writer]()
    src.build_index(_nodes(x))
    src.enable_pq(chunks=8, ksub=32, opq_iters=2)
    src.delete(5)
    src.save_index()
    dst = make["port" if writer == "jax" else "jax"]()   # loads at __init__
    assert dst.get_cluster_stats() == src.get_cluster_stats()
    np.testing.assert_allclose(np.asarray(dst.centroids), src.centroids)
    port, ref = (dst, src) if writer == "jax" else (src, dst)
    for pq in (False, True):
        _check(port, ref, q, n_probe=4, top_k=10, pq=pq)


def _brute(x, q, k, rows=None):
    rows = np.arange(x.shape[0]) if rows is None else np.asarray(rows)
    d = ((q[:, None, :] - x[rows][None]) ** 2).sum(-1)
    return rows[np.argsort(d, axis=1)[:, :k]]


def test_port_built_index_meets_ivf_floors():
    """tests/index/test_ivf.py's contract on a port-built index."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((100, 16)).astype(np.float32)
    index = IvfIndex(k=4, device="cpu")
    index.build_index(_nodes(x))
    ok = 0
    for _ in range(10):
        qv = rng.standard_normal(16).astype(np.float32)
        got = {nd.id for nd, _ in index.search(qv, n_probe=4, top_k=5)}
        ok += len(got & set(_brute(x, qv[None], 5)[0].tolist())) / 5 >= 0.6
    assert ok >= 7
    qv = rng.standard_normal(16).astype(np.float32)
    got = [nd.id for nd, _ in index.search(qv, n_probe=4, top_k=10)]
    assert got == _brute(x, qv[None], 10)[0].tolist()   # full probe: exact
    hit = index.search(x[11], n_probe=4, top_k=1)
    assert hit[0][0].id == 11 and hit[0][1] < 1e-3
    d, ids = index.search_batch(x[:6], n_probe=4, top_k=3)
    assert d.shape == (6, 3) and np.all(np.diff(d, axis=1) >= -1e-6)


def test_port_built_index_meets_ivf_pq_floors():
    """tests/index/test_ivf_pq.py's floors, at its n_probe = k (the full
    scan)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, 32)).astype(np.float32)
    index = IvfIndex(k=8, device="cpu")
    index.build_index(_nodes(x))
    index.enable_pq(chunks=8, ksub=32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    _, ids = index.search_batch(q, n_probe=8, top_k=5, pq=True)
    assert recall(ids, _brute(x, q, 5)) >= 0.7
    d, ids = index.search_batch(x[:3], n_probe=8, top_k=1, pq=True)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2])
    assert np.all(d[:, 0] < 1e-2)
    allowed = set(int(i) for i in rng.choice(400, 150, replace=False))
    _, ids = index.search_batch(q, n_probe=8, top_k=5, pq=True,
                                filter_ids=allowed, fetch=128)
    want = _brute(x, q, 5, rows=sorted(allowed))
    for i in range(6):
        got = [int(v) for v in ids[i] if v >= 0]
        assert set(got) <= allowed
        assert len(set(got) & set(want[i].tolist())) >= 4   # PQ noise only


def test_port_build_arrays_spill_dedups():
    rng, x, q = _data(6, rows=2000, dim=16)
    index = IvfIndex(k=16, device="cpu")
    index.build_arrays(range(2000), x, seed=0, iters=10, spill=2,
                       list_cap_alpha=2.0)
    assert index.get_cluster_stats()["total_vectors"] > 2000
    _, ids = index.search_batch(q, n_probe=16, top_k=10)
    for row in ids:
        assert len(set(row.tolist())) == 10
    np.testing.assert_array_equal(ids, _brute(x, q, 10))
    index.enable_pq(chunks=4, ksub=16, residual=False)
    _, own = index.search_batch(x[:5], n_probe=8, top_k=1, pq=True)
    np.testing.assert_array_equal(own[:, 0], np.arange(5))


def _raises(make):
    """(type, message) of what ``make()`` raises."""
    with pytest.raises(Exception) as e:
        make()
    return e.type, str(e.value)


@pytest.mark.parametrize("case", [
    "k0", "empty", "too_few", "search_unbuilt", "add_unbuilt",
    "enable_unbuilt", "pq_unenabled", "dim", "n_probe", "residual_spill"])
def test_errors_match_jax(case):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((60, 8)).astype(np.float32)

    def run(cls, **kw):
        new = lambda k=4: cls(k=k, **kw)           # noqa: E731

        def built(**b):
            idx = new()
            if b:
                idx.build_arrays(range(60), x, **b)
            else:
                idx.build_index(_nodes(x))
            return idx
        return {
            "k0": lambda: new(0),
            "empty": lambda: new().build_index([]),
            "too_few": lambda: new(10).build_index(_nodes(x[:5])),
            "search_unbuilt": lambda: new().search(x[0], 1, 1),
            "add_unbuilt": lambda: new().add(_nodes(x[:1])[0]),
            "enable_unbuilt": lambda: new().enable_pq(),
            "pq_unenabled": lambda: built().search_batch(x[:1], 2, 1,
                                                         pq=True),
            "dim": lambda: built().search(x[0, :4], 2, 1),
            "n_probe": lambda: built().search(x[0], 5, 1),
            "residual_spill": lambda: built(spill=2).enable_pq(chunks=2),
        }[case]()

    assert _raises(lambda: run(IvfIndex, device="cpu")) == \
        _raises(lambda: run(JaxIvf))


def test_unknown_adc_mode_raises():
    _, x, q = _data(8, rows=200)
    index = IvfIndex(k=4, device="cpu")
    index.build_index(_nodes(x))
    index.enable_pq(chunks=4, ksub=16)
    with pytest.raises(ValueError, match="adc"):
        index.search_batch(q, 2, 3, pq=True, adc="bogus")


def _same_init(mp, seed):
    """Both packages' k-means draw their initial rows by one numpy rule: the
    i-th k-means call of a build takes, for each restart and subspace, the
    first k rows of a permutation seeded by (seed, i). A build is then the
    same computation in either package, from the same start (each
    package's own Lloyd's, restarts, OPQ, balanced assignment and
    encoding), so what remains between them is float rounding."""
    import jax
    import jax.numpy as jnp
    import torch

    import vector_db_tpu.index.ivf as jax_ivf
    import vector_db_tpu.index.pq as jax_pq
    import vector_db_tpu_torch.index.ivf as port_ivf
    import vector_db_tpu_torch.index.pq as port_pq
    from vector_db_tpu.ops.kmeans import _lloyd as jax_lloyd
    from vector_db_tpu_torch.ops.kmeans import _lloyd as port_lloyd

    calls = {"jax": 0, "port": 0}

    def draws(who, s, n, k, restarts):
        rng = np.random.default_rng([seed, calls[who]])
        calls[who] += 1
        return [np.stack([rng.permutation(n)[:k] for _ in range(s)])
                for _ in range(restarts)]

    lloyd = jax.jit(lambda x, init, iters: jax.vmap(
        lambda a, b: jax_lloyd(a, b, iters))(x, init), static_argnums=2)

    def best_of(runs, where):
        best = None
        for c, lab, inertia in runs:
            if best is not None:
                better = inertia < best[2]
                c = where(better[:, None, None], c, best[0])
                lab = where(better[:, None], lab, best[1])
                inertia = where(better, inertia, best[2])
            best = (c, lab, inertia)
        return best[0], best[1]

    def jax_multi(x, k, key, iters=100, restarts=1):
        x = jnp.asarray(x)
        return best_of((lloyd(x, jnp.take_along_axis(
            x, jnp.asarray(idx)[:, :, None], axis=1), iters)
            for idx in draws("jax", *x.shape[:2], k, restarts)), jnp.where)

    def port_multi(x, k, generator, iters=100, restarts=1):
        return best_of((port_lloyd(x, torch.gather(
            x, 1, torch.from_numpy(idx)[:, :, None].expand(
                -1, -1, x.shape[2])), iters)
            for idx in draws("port", *x.shape[:2], k, restarts)),
            torch.where)

    def single(multi):
        def kmeans(x, k, key, iters=100, restarts=1):
            c, lab = multi(x[None], k, key, iters=iters, restarts=restarts)
            return c[0], lab[0]
        return kmeans

    mp.setattr(jax_pq, "kmeans_multi", jax_multi)
    mp.setattr(jax_ivf, "kmeans", single(jax_multi))
    mp.setattr(port_pq, "kmeans_multi", port_multi)
    mp.setattr(port_ivf, "kmeans", single(port_multi))


def c1_recalls(rows, cells, ksub, seeds, same_init, opq_iters=1, n_probe=6,
               fetch=64, queries=200, n_clusters=64):
    """IVF-PQ recall@10 against brute force of both packages built on the
    CPU from the same sift_like rows (128-d) with chip_smoke.py's phase 4
    settings cut to size: build_arrays(iters=20, spill=1,
    list_cap_alpha=2.0), residual PQ of 16 subspaces with OPQ, fetch then
    exact rerank. Per seed: ``jax``, ``port``, and ``port_on_jax_state``
    (the port searching JAX's trained state, which separates training from
    search). With ``same_init`` the two builds draw their k-means initial
    rows alike (:func:`_same_init`). Fault C1 of ROADMAP.md at a larger
    size than the test's, e.g. ``c1_recalls(30000, 256, 256, range(6),
    False, opq_iters=4, n_probe=16, fetch=512, queries=300,
    n_clusters=None)`` (about 4 minutes a seed)."""
    from vector_db_tpu.datasets import sift_like

    out = {"jax": [], "port": [], "port_on_jax_state": []}
    for seed in seeds:
        kw = {} if n_clusters is None else {"n_clusters": n_clusters}
        x, q = sift_like(rows, dim=128, seed=seed, queries=queries, **kw)
        x64, q64 = x.astype(np.float64), q.astype(np.float64)
        d = (q64 * q64).sum(1)[:, None] - 2 * q64 @ x64.T + (
            x64 * x64).sum(1)[None]
        truth = np.argsort(d, axis=1)[:, :10]
        with pytest.MonkeyPatch.context() as mp:
            if same_init:
                _same_init(mp, seed)
            for name, idx in (("jax", JaxIvf(k=cells)),
                              ("port", IvfIndex(k=cells, device="cpu"))):
                idx.build_arrays(range(rows), x, seed=seed, iters=20,
                                 spill=1, list_cap_alpha=2.0)
                idx.enable_pq(chunks=16, ksub=ksub, seed=seed,
                              opq_iters=opq_iters, residual=True)
                kw = {"adc": "gather"} if name == "jax" else {}
                _, ids = idx.search_batch(q, n_probe, 10, pq=True,
                                          fetch=fetch, **kw)
                out[name].append(recall(ids, truth))
                if name == "jax":
                    _, ids = _carry(idx).search_batch(q, n_probe, 10,
                                                      pq=True, fetch=fetch)
                    out["port_on_jax_state"].append(recall(ids, truth))
    return out


def test_ivf_pq_recall_matches_jax_on_sift_like():
    """Suspected fault C1 (the port's IVF-PQ recall under JAX's on the
    same corpus and settings), held on the CPU over 3 seeds. Training is
    held seed by seed: with the k-means initial rows drawn alike
    (:func:`_same_init`), the port's recall@10 may trail JAX's by at most
    0.005 on the mean over the seeds (C1 was a gap of 0.007) and 0.01 in
    any seed. One OPQ iteration: a second turns float rounding into
    +-0.02 swings of one seed's recall, where the two builds from one
    start agree within 0.006. Search alone: the port on JAX's trained
    state gives JAX's recall within 0.01 (ADC sums in another order can
    swap near-tied candidates at the fetch cut). The draw itself is held
    by test_torch_kmeans.py."""
    r = c1_recalls(3000, 16, 32, range(3), same_init=True)
    diff = np.subtract(r["port"], r["jax"])
    print(f"recall@10 per seed {r}; port - jax {diff}")
    assert diff.mean() >= -0.005 and diff.min() >= -0.01
    assert abs(np.mean(r["port_on_jax_state"]) - np.mean(r["jax"])) <= 0.01
