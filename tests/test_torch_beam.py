"""The wide beam's PQ-decoded mirror, the int8 inline tables and the
pool-free beam of the port, against the JAX package on the CPU.

- ``build_inline_tables``: the int8 blocks equal JAX's bit for bit where
  the mirror is exact in both (no projection, or a coordinate projection);
  under a random projection the two f32 products differ in the last bits,
  so an entry may round the other way: >= 99.9 % equal, none apart by
  more than 1. Scales and norms within rtol 1e-6.
- ``build_aug_table_pq``: bf16 rows equal JAX's within one bf16 step
  (2^-7 relative: the decode and rotation are f32 sums in another order).
- ``beam_search`` and ``wide_search`` (inline tables, PQ scores) on a JAX
  graph carried over with ``load_state`` (the wide projection carried too):
  both packages select exactly (JAX's ``approx_min_k`` is exact on the
  CPU), ties to the lower position: id sets equal on >= 99 % of the
  queries and recall@10 no lower than JAX's less 0.01; distances exact.
  The inline wide search holds 99 % without a projection and under a PCA
  of 24 dims on a corpus it keeps (rank 16 plus noise). One further case
  runs that PCA on the isotropic corpus, where it keeps half the variance:
  the coarse estimates' last bits (the projection's product, XLA's own
  evaluation of the estimate) flip near-ties at the pool's cut, and the
  top 10 follows them: id sets on >= 85 %, recall as above.
- The JAX package's pool-free beam and PQ-scored wide contracts
  (tests/index/test_wide_beam.py:153-309) on the port.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import n, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.index import wide_beam as JWB
from vector_db_tpu.index.hnsw import HNSW as JaxHNSW
from vector_db_tpu_torch.index import wide_beam as WB
from vector_db_tpu_torch.index.hnsw import HNSW

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, DIM, M = 4000, 48, 8


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    q = rng.normal(size=(50, DIM)).astype(np.float32)
    ref = JaxHNSW(M=M, ef_construction=100, rng=random.Random(42),
                  capacity=N, l_max=4)
    ref.bulk_build(list(range(N)), x)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), 1)[:, :10]
    return ref, x, q, gt


def _recall(ids, gt, k=10):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                          for a, b in zip(ids, gt)]))


def _carry(ref, pq=False):
    """The port on the JAX index's graph, wide state (and PQ state)."""
    port = HNSW(M=ref.M, ef_construction=ref.ef_construction,
                rng=random.Random(0), l_max=ref.l_max, device="cpu")
    g = ref.graph
    kw = dict(wb_proj=None if ref._wb_proj is None else np.asarray(
        ref._wb_proj), wb_n_seeds=ref._wb_n_seeds,
        wb_inline=getattr(ref, "_wb_inline", False))
    if pq:
        rot = ref._pq.rotation
        kw.update(pq_codebooks=np.asarray(ref._pq.codebooks),
                  pq_rotation=None if rot is None else np.asarray(rot),
                  pq_codes=np.asarray(ref._pq_codes))
    port.load_state(np.asarray(g.neighbors), np.asarray(g.levels),
                    int(g.entry), int(g.entry_level),
                    np.asarray(ref._store.emb), np.asarray(ref._store.valid),
                    ref._store.export_id_map(), **kw)
    return port


def _near(got, want, gt, share=0.99):
    same = np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                    for a, b in zip(got, want)])
    assert same >= share, same
    assert _recall(got, gt) >= _recall(want, gt) - 0.01


def _exact(d, ids, x, q, rows=8):
    for i in range(rows):
        sel = ids[i][ids[i] >= 0]
        assert len(set(sel.tolist())) == len(sel)
        dref = np.sqrt(((q[i] - x[sel]) ** 2).sum(-1))
        np.testing.assert_allclose(d[i][: len(sel)], dref, rtol=1e-4)
        assert np.all(np.diff(d[i][: len(sel)]) >= -1e-5)


# -- the tables ------------------------------------------------------------
def _projections(dim, rng):
    coord = np.zeros((dim, 20), np.float32)
    coord[rng.choice(dim, 20, replace=False), np.arange(20)] = 1.0
    rand = np.linalg.qr(rng.standard_normal((dim, 20)))[0].astype(np.float32)
    return {"none": None, "coordinate": coord, "random": rand}


@pytest.mark.parametrize("proj", ["none", "coordinate", "random"])
def test_inline_tables_equal_jax(proj):
    rng = np.random.default_rng(1)
    cap, w = 700, 12
    x = (3.0 * rng.standard_normal((cap, DIM))).astype(np.float32)
    x[5] = 0.0                                 # a zero row: the 1e-9 scale
    x[6, :] = 0.5                              # ties at .5 steps
    nb = rng.integers(-1, cap, (cap, w)).astype(np.int32)
    valid = rng.random(cap) > 0.1
    p = _projections(DIM, rng)[proj]
    got = WB.build_inline_tables(t(nb), t(x), t(valid),
                                 None if p is None else t(p))
    want = JWB.build_inline_tables(jnp.asarray(nb), jnp.asarray(x),
                                   jnp.asarray(valid),
                                   None if p is None else jnp.asarray(p))
    gi, wi = n(got[0]), np.asarray(want[0])
    assert gi.dtype == np.int8 and gi.shape == wi.shape
    assert gi.shape[-1] % 128 == 0
    if proj == "random":
        assert np.mean(gi == wi) >= 0.999
        assert np.abs(gi.astype(int) - wi.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(n(got[1]), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(n(got[2]), np.asarray(want[2]), rtol=1e-6)


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("proj", [False, True])
def test_aug_table_pq_equals_jax(rotate, proj):
    rng = np.random.default_rng(2)
    cap, m, ksub, sub = 500, 6, 32, 8
    dim = m * sub
    codes = rng.integers(0, ksub, (cap, m)).astype(np.int32)
    cb = rng.standard_normal((m, ksub, sub)).astype(np.float32)
    rot = (np.linalg.qr(rng.standard_normal((dim, dim)))[0].astype(
        np.float32) if rotate else None)
    p = (np.linalg.qr(rng.standard_normal((dim, 16)))[0].astype(np.float32)
         if proj else None)
    valid = rng.random(cap) > 0.2
    got = n(WB.build_aug_table_pq(t(codes), t(cb),
                                  None if rot is None else t(rot), t(valid),
                                  None if p is None else t(p)))
    want = np.asarray(JWB.build_aug_table_pq(
        jnp.asarray(codes), jnp.asarray(cb),
        None if rot is None else jnp.asarray(rot), jnp.asarray(valid),
        None if p is None else jnp.asarray(p)), np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-5)


def test_inline_scores_equal_jax_int8_dot():
    """One step's inline estimates: the exact int32 dot of JAX, bit for
    bit (same tables and query quantization)."""
    rng = np.random.default_rng(3)
    cap, w = 300, 16
    x = rng.standard_normal((cap, DIM)).astype(np.float32)
    nb = rng.integers(0, cap, (cap, w)).astype(np.int32)
    tabs = WB.build_inline_tables(t(nb), t(x), t(np.ones(cap, bool)), None)
    qa = WB.aug_queries(t(rng.standard_normal((5, DIM)).astype(np.float32)),
                        None, DIM + 8)
    frontier = t(rng.integers(0, cap, (5, 7)).astype(np.int32))
    q_i8, q_scale = WB._inline_queries(qa, tabs[0].shape[-1])
    got = n(WB._inline_scores(tabs, frontier, q_i8, q_scale))
    blk = n(tabs[0])[n(frontier)].astype(np.int32)
    dots = np.einsum("bfnd,bd->bfn", blk, n(q_i8).astype(np.int32))
    want = (n(tabs[2])[n(frontier)] - (2.0 * n(q_scale))[:, None, None]
            * n(tabs[1])[n(frontier)] * dots.astype(np.float32))
    np.testing.assert_array_equal(got, want.reshape(5, -1))


# -- searches on a carried graph, against JAX ------------------------------
@pytest.mark.parametrize("inline", [False, True])
@pytest.mark.parametrize("dims", [None, 24])
def test_beam_search_matches_jax(built, inline, dims):
    ref, x, q, gt = built
    ref.enable_wide(dims=dims, seeds=512, inline=inline)
    port = _carry(ref)
    kw = dict(k=10, frontier=48, steps=14)
    _, want = ref.search_batch_beam(q, **kw)
    d, got = port.search_batch_beam(q, **kw)
    _near(got, want, gt)
    _exact(d, got, x, q)


def test_beam_search_filtered_matches_jax(built):
    ref, x, q, gt = built
    ref.enable_wide(dims=None, seeds=512, inline=True)
    port = _carry(ref)
    allowed = set(range(0, N, 4))
    kw = dict(k=10, frontier=48, steps=14, rerank_k=256, filter_ids=allowed)
    _, want = ref.search_batch_beam(q, **kw)
    _, got = port.search_batch_beam(q, **kw)
    assert set(got[got >= 0].tolist()) <= allowed
    al = np.asarray(sorted(allowed))
    gt_f = al[np.argsort(((q[:, None] - x[al][None]) ** 2).sum(-1),
                         1)[:, :10]]
    _near(got, want, gt_f)


@pytest.fixture(scope="module")
def built_lowrank():
    """A corpus of rank 16 plus noise, which the PCA projection of 24 dims
    keeps: the data a wide projection is for."""
    rng = np.random.default_rng(7)
    base = (rng.normal(size=(N + 50, 16)).astype(np.float32)
            @ rng.normal(size=(16, DIM)).astype(np.float32))
    data = (base + 0.6 * rng.normal(size=base.shape)).astype(np.float32)
    x, q = data[:N], data[N:]
    ref = JaxHNSW(M=M, ef_construction=100, rng=random.Random(42),
                  capacity=N, l_max=4)
    ref.bulk_build(list(range(N)), x)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), 1)[:, :10]
    return ref, x, q, gt


@pytest.mark.parametrize("dims", [None, 24])
@pytest.mark.parametrize("merge_kernel", [False, True])
def test_wide_inline_matches_jax(request, merge_kernel, dims):
    """Inline wide search: no projection, or JAX's PCA of 24 dims (carried)
    on a corpus that projection keeps."""
    ref, x, q, gt = request.getfixturevalue(
        "built" if dims is None else "built_lowrank")
    ref.enable_wide(dims=dims, seeds=512, inline=True)
    port = _carry(ref)
    kw = dict(k=10, ef=256, frontier=32, steps=12, merge_kernel=merge_kernel)
    _, want = ref.search_batch_wide(q, **kw)
    d, got = port.search_batch_wide(q, **kw)
    _near(got, want, gt)
    _exact(d, got, x, q)


@pytest.mark.parametrize("merge_kernel", [False, True])
def test_wide_inline_pca_near_jax(built, merge_kernel):
    """The same search under the PCA of 24 dims on the isotropic corpus,
    which keeps half its variance: the estimates are coarse, so last-bit
    differences in them (the projection's f32 product, XLA's own
    evaluation of the inline estimate, another order than the port's)
    flip near-ties at the pool's cut, and the top 10 follows: id sets on
    >= 85 % of the queries, recall no lower than JAX's less 0.01."""
    ref, x, q, gt = built
    ref.enable_wide(dims=24, seeds=512, inline=True)
    port = _carry(ref)
    kw = dict(k=10, ef=256, frontier=32, steps=12, merge_kernel=merge_kernel)
    _, want = ref.search_batch_wide(q, **kw)
    d, got = port.search_batch_wide(q, **kw)
    _near(got, want, gt, share=0.85)
    _exact(d, got, x, q)


@pytest.mark.parametrize("mode", ["wide", "beam"])
def test_pq_scored_matches_jax(built, mode):
    ref, x, q, gt = built
    if getattr(ref, "_pq", None) is None:
        ref.enable_pq(chunks=6, ksub=32, opq_iters=2)
    ref.enable_wide(dims=None, seeds=512)
    port = _carry(ref, pq=True)
    aug, _ = port._wide_tables_pq()
    jaug, _ = ref._wide_tables_pq()
    np.testing.assert_allclose(n(aug), np.asarray(jaug, np.float32),
                               rtol=2.0 ** -7, atol=1e-5)
    call = "search_batch_wide" if mode == "wide" else "search_batch_beam"
    kw = (dict(k=10, ef=256, frontier=32, steps=12, rerank_k=256)
          if mode == "wide" else dict(k=10, frontier=64, steps=14,
                                      rerank_k=512))
    _, want = getattr(ref, call)(q, score="pq", **kw)
    d, got = getattr(port, call)(q, score="pq", **kw)
    _near(got, want, gt)
    _exact(d, got, x, q)


def test_inline_tables_follow_mutations(built):
    """After an insert and a delete the inline tables rebuild (the
    _version counter): the new row is its own top-1 on the inline wide and
    beam searches, the deleted one never returns."""
    ref, x, q, _ = built
    ref.enable_wide(dims=None, seeds=512)
    port = _carry(ref)
    port.enable_wide(dims=None, seeds=512, inline=True)
    port.search_batch_beam(q[:2], 5)
    v = x[11] + 0.01
    port.insert_arrays([7777], v[None, :])
    port.delete_node(12)
    assert port._wb[0] != port._version
    for call in (lambda qq, k: port.search_batch_beam(qq, k),
                 lambda qq, k: port.search_batch_wide(qq, k, ef=128,
                                                      frontier=16, steps=10)):
        assert call(v[None, :], 1)[1][0, 0] == 7777
        assert 12 not in call(x[12:13], 5)[1]
    np.testing.assert_array_equal(
        n(port._wb[3][0]),
        n(WB.build_inline_tables(port.graph.neighbors[:, :2 * M], port._emb,
                                 port._has_emb, None)[0]))


# -- tests/index/test_wide_beam.py:153-309 on the port ----------------------
@pytest.fixture(scope="module")
def port_built(built):
    ref, x, q, gt = built
    port = HNSW(M=M, ef_construction=100, rng=random.Random(42), capacity=N,
                l_max=4, device="cpu")
    port.bulk_build(list(range(N)), x)
    return port, x, q, gt


def test_wide_pq_score_full_rerank(port_built):
    idx, x, q, gt = port_built
    idx.enable_pq(chunks=6, ksub=32, opq_iters=2)
    idx.enable_wide(dims=None, seeds=512)
    _, i_ex = idx.search_batch_wide(q, k=10, ef=256, frontier=32, steps=12)
    d_pq, i_pq = idx.search_batch_wide(q, k=10, ef=256, frontier=32,
                                       steps=12, score="pq", rerank_k=256)
    assert _recall(i_pq, gt) >= _recall(i_ex, gt) - 0.3
    assert _recall(i_pq, gt) >= 0.6
    _exact(d_pq, i_pq, x, q, rows=4)


def test_wide_pq_requires_enable_pq():
    x = np.random.default_rng(4).normal(size=(300, 16)).astype(np.float32)
    idx = HNSW(M=4, ef_construction=20, rng=random.Random(1), device="cpu")
    idx.bulk_build(range(300), x)
    idx.enable_wide(dims=None, seeds=64)
    for call in ("search_batch_wide", "search_batch_beam"):
        with pytest.raises(ValueError, match="enable_pq"):
            getattr(idx, call)(x[:1], 5, score="pq")
    with pytest.raises(ValueError, match="score"):
        idx.search_batch_wide(x[:1], 5, score="rp")


def test_beam_recall_vs_brute_force(port_built):
    idx, x, q, gt = port_built
    idx.enable_wide(dims=None, seeds=512)
    _, ids = idx.search_batch_beam(q, k=10, frontier=48, steps=14)
    assert _recall(ids, gt) >= 0.9


def test_beam_exact_distances_sorted_no_dups(port_built):
    idx, x, q, gt = port_built
    idx.enable_wide(dims=None, seeds=512)
    d, ids = idx.search_batch_beam(q, k=10, frontier=32, steps=10)
    _exact(d, ids, x, q, rows=len(q))


def test_beam_inline_tables_agree(port_built):
    idx, x, q, gt = port_built
    idx.enable_wide(dims=None, seeds=512, inline=True)
    _, ids = idx.search_batch_beam(q, k=10, frontier=48, steps=14)
    assert _recall(ids, gt) >= 0.9


def test_beam_pq_score_exact_distances(port_built):
    idx, x, q, gt = port_built
    if idx._pq is None:
        idx.enable_pq(chunks=6, ksub=32, opq_iters=2)
    idx.enable_wide(dims=None, seeds=512)
    _, i_ex = idx.search_batch_beam(q, k=10, frontier=64, steps=14,
                                    rerank_k=512)
    d_pq, i_pq = idx.search_batch_beam(q, k=10, frontier=64, steps=14,
                                       score="pq", rerank_k=512)
    assert _recall(i_pq, gt) >= _recall(i_ex, gt) - 0.35
    assert _recall(i_pq, gt) >= 0.5
    _exact(d_pq, i_pq, x, q, rows=4)


def test_beam_filter_ids(port_built):
    idx, x, q, gt = port_built
    idx.enable_wide(dims=None, seeds=512)
    rng = np.random.default_rng(9)
    allowed = set(int(i) for i in rng.choice(N, size=N // 4, replace=False))
    _, ids = idx.search_batch_beam(q, k=10, frontier=48, steps=14,
                                   rerank_k=256, filter_ids=allowed)
    al = np.asarray(sorted(allowed))
    gt_f = al[np.argsort(((q[:, None] - x[al][None]) ** 2).sum(-1),
                         1)[:, :10]]
    assert set(ids[ids >= 0].tolist()) <= allowed
    assert _recall(ids, gt_f) >= 0.75


def test_inline_qchunk_budget_splits_the_batch(port_built, monkeypatch):
    """Inline exact traversal chunks the batch at max frontier * padded
    queries within its budget (2^18 by default, the JAX package's inline
    envelope; patched small here), in chunks of at least 128; chunking
    leaves every query's answer as it was."""
    idx, x, q, _ = port_built
    idx.enable_wide(dims=None, seeds=512, inline=True)
    seen = []
    real = WB.wide_search

    def spy(*a, **kw):
        seen.append(a[5].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(WB, "wide_search", spy)
    monkeypatch.setattr("vector_db_tpu_torch.index.hnsw._INLINE_BUDGET",
                        64 * 128)
    qq = np.concatenate([q] * 6)
    d1, i1 = idx.search_batch_wide(qq, k=10, ef=128, frontier=64, steps=6)
    assert seen == [128, 128, 64]
    seen.clear()
    d2, i2 = idx.search_batch_wide(qq, k=10, ef=128, frontier=64, steps=6,
                                   qchunk=0)
    assert seen == [512]
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def wide_inline_recalls(rows, dim, queries=200, seed=0, dims=64,
                        seeds=2048, ef=256, frontier=48, steps=10):
    """recall@10 against brute force of ``search_batch_wide`` on one numpy
    ``embedding_like`` corpus (the 1M runs' generator), with the 1M runs'
    wide settings cut to size (dedup 16, no seen mask; JAX's 1M reading
    used ``enable_wide(inline=True)``, the port's phase 5 the aug mirror):
    "jax_inline" (the JAX package), "port_inline_carried" (the port on
    JAX's graph and wide projection), "port_inline_own" and
    "port_mirror_own" (the port's own bulk build and projection). The
    settling run of ROADMAP C, at a larger size than its test:

        JAX_PLATFORMS=cpu python -c "from tests.test_torch_beam import \\
            wide_inline_recalls as f; print(f(30000, 128))"
    """
    from vector_db_tpu_torch import datasets

    data = datasets.embedding_like(rows + queries, dim, seed=seed)
    x, q = data[:rows], data[rows:]
    d = (q * q).sum(1)[:, None] - 2 * q @ x.T + (x * x).sum(1)[None]
    gt = np.argsort(d, 1)[:, :10]
    kw = dict(k=10, ef=ef, frontier=frontier, steps=steps, dedup_window=16,
              seen_mask=False)
    ref = JaxHNSW(M=16, ef_construction=200, rng=random.Random(42),
                  capacity=rows, l_max=5)
    ref.bulk_build(list(range(rows)), x)
    ref.enable_wide(dims=dims, seeds=seeds, inline=True)
    out = {"jax_inline": _recall(ref.search_batch_wide(q, **kw)[1], gt)}
    out["port_inline_carried"] = _recall(
        _carry(ref).search_batch_wide(q, **kw)[1], gt)
    own = HNSW(M=16, ef_construction=200, rng=random.Random(42),
               capacity=rows, l_max=5, device="cpu")
    own.bulk_build(list(range(rows)), x)
    own.enable_wide(dims=dims, seeds=seeds, inline=True)
    out["port_inline_own"] = _recall(own.search_batch_wide(q, **kw)[1], gt)
    own.enable_wide(dims=dims, seeds=seeds)
    out["port_mirror_own"] = _recall(own.search_batch_wide(q, **kw)[1], gt)
    return out


def test_wide_inline_recall_gap_on_one_corpus():
    """ROADMAP C: on one embedding_like corpus the port's inline wide
    search reads JAX's recall on JAX's graph (within 0.01), and on its own
    build too (within 0.02: the builds' k-means differ)."""
    r = wide_inline_recalls(3000, 48, queries=100, dims=24, seeds=512,
                            ef=128, frontier=24)
    assert r["port_inline_carried"] >= r["jax_inline"] - 0.01, r
    assert r["port_inline_own"] >= r["jax_inline"] - 0.02, r
