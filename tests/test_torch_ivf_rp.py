"""IVF residual projection and the full-scan IVF-PQ of the port, on the CPU,
against the JAX IvfIndex on the same state.

A JAX index with RP (and PQ) enabled is carried over with ``load_state``
(its projection and mean too, so both packages score with the same
eigenvectors: an ``eigh`` of two covariances that differ in the last bits
may flip a sign or rotate a near-degenerate subspace). Then the three RP
routes (probe, cell-block scan, flat mirror) and the PQ full scan must
return the same id sets on >= 99 % of the queries, with exact distances
within rtol 1e-4. The TPU's ``approx_min_k`` is exact on the CPU, as the
port's selection is everywhere, so candidate sets agree. Un-reranked PQ
scan estimates are held to 2^-16 of the LUT sum's size: the JAX package
sums a hi/lo bf16 LUT pair, the port f32 (plus 1e-4 for f32 order). The
JAX tests' RP/PQ-scan contracts (tests/index/test_ivf_scale.py,
test_ivf.py) run on the port too.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import recall
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.index.ivf import IvfIndex as JaxIvf
from vector_db_tpu.index.ivf import _ivf_pq_scan_cells as jax_pq_scan
from vector_db_tpu.storage import InMemoryNodeStorage
from vector_db_tpu.types import Node
from vector_db_tpu_torch.index import ivf as ivf_mod
from vector_db_tpu_torch.index.ivf import IvfIndex

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _lowrank(n, dim=64, rank=8, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, rank)).astype(np.float32)
    v = rng.standard_normal((rank, dim)).astype(np.float32)
    x = u @ v + 0.05 * rng.standard_normal((n, dim)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _gauss(n, dim, seed):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(
        np.float32)


def _clustered(n=4096, dim=64, seed=0):
    """tests/index/test_ivf_scale.py's corpus: 32 Gaussian clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, dim)).astype(np.float32) * 3
    x = centers[rng.integers(0, 32, n)] + rng.standard_normal(
        (n, dim)).astype(np.float32)
    return x.astype(np.float32)


def _carry(ref):
    """The port holding the JAX index's state, its RP and PQ included."""
    port = IvfIndex(k=ref.k, storage=ref.storage, device="cpu")
    kw = {}
    if getattr(ref, "_pq", None) is not None:
        rot = ref._pq.rotation
        kw.update(codebooks=np.asarray(ref._pq.codebooks),
                  rotation=None if rot is None else np.asarray(rot),
                  residual=ref._pq_residual, codes=ref._codes_np,
                  sx=ref._sx_np)
    if getattr(ref, "_rp_proj", None) is not None:
        kw.update(rp_proj=ref._rp_proj, rp_mu=np.asarray(ref._rp_mu_dev),
                  rp_res_ratio=ref._rp_res_ratio)
    port.load_state(np.asarray(ref._store.emb), np.asarray(ref._store.valid),
                    ref._store.export_id_map(), ref.centroids,
                    ref.inverted_lists, spill=getattr(ref, "_spill", 1), **kw)
    return port


def _rp_pair(x, k, spill=1, dims=16):
    ref = JaxIvf(k=k)
    ref.build_arrays(range(x.shape[0]), x, seed=0, iters=10, spill=spill)
    ref.enable_rp(dims=dims)
    return ref, _carry(ref)


def _agree(got, want, share=0.99):
    """Same id sets on >= ``share`` of the queries; distances of the ids
    both return within rtol 1e-4 (exact reranked L2)."""
    (dg, ig), (dw, iw) = got, want
    same = np.mean([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                    for a, b in zip(ig, iw)])
    assert same >= share, same
    for r in range(ig.shape[0]):
        common = set(ig[r][ig[r] >= 0].tolist()) & set(iw[r][iw[r] >= 0]
                                                      .tolist())
        for nid in common:
            a = dg[r][ig[r] == nid][0]
            b = dw[r][iw[r] == nid][0]
            assert abs(a - b) <= 1e-4 * max(abs(b), 1e-3), (nid, a, b)
    return same


ROUTES = {"probe": (4, None), "scan": (32, 0.0), "flat": (32, 1.0)}


@pytest.mark.parametrize("spill", [1, 2])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rp_routes_match_jax(route, spill):
    """Each of the three RP routes, chosen as JAX chooses (n_probe against
    k, and ``_rp_res_ratio`` set on both to pick scan or flat), returns
    JAX's ids and exact distances, spilled copies deduplicated."""
    data = _lowrank(3000 + 64, seed=1)
    x, q = data[:3000], data[3000:]
    ref, port = _rp_pair(x, 32, spill=spill)
    n_probe, ratio = ROUTES[route]
    if ratio is not None:
        ref._rp_res_ratio = port._rp_res_ratio = ratio
    for fetch in (64, 300):     # 300: the l2 scan past 256 (k > 256)
        got = port.search_batch(q, n_probe=n_probe, top_k=10, rp=True,
                                fetch=fetch)
        want = ref.search_batch(q, n_probe=n_probe, top_k=10, rp=True,
                                fetch=fetch)
        _agree(got, want)
        ids = got[1]
        assert all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum())
                   for r in ids)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rp_routes_filtered_and_unreranked_match_jax(route):
    """The filter folds into the validity mask of every route; un-reranked
    ids agree too (the estimates come from the same bf16 operands)."""
    x = _gauss(1500, 24, 3)
    q = _gauss(16, 24, 4)
    ref, port = _rp_pair(x, 16, dims=12)
    n_probe, ratio = {"probe": (5, None), "scan": (16, 0.0),
                      "flat": (16, 1.0)}[route]
    if ratio is not None:
        ref._rp_res_ratio = port._rp_res_ratio = ratio
    allowed = set(range(0, 1500, 3))
    kw = dict(n_probe=n_probe, top_k=8, rp=True, fetch=96,
              filter_ids=allowed)
    got = port.search_batch(q, **kw)
    _agree(got, ref.search_batch(q, **kw))
    assert set(got[1][got[1] >= 0].tolist()) <= allowed
    kw = dict(n_probe=n_probe, top_k=8, rp=True, fetch=96, rerank=False)
    (dg, ig), (dw, iw) = port.search_batch(q, **kw), ref.search_batch(q, **kw)
    assert np.mean([set(a) == set(b) for a, b in zip(ig.tolist(),
                                                    iw.tolist())]) >= 0.9
    np.testing.assert_allclose(np.sort(dg, 1), np.sort(dw, 1), rtol=1e-3,
                               atol=1e-3)


def test_rp_state_matches_jax_after_add_and_delete():
    """enable_rp's per-slot x^ and norms, the cell blocks and the flat
    mirror equal JAX's; add keeps x^ current (the added row is its own
    top-1 on every route), delete drops the row from every route."""
    x = _gauss(800, 32, 5)
    ref, port = _rp_pair(x, 8, spill=2)
    rng = np.random.default_rng(6)
    fresh = x[:3] + 0.05 * rng.standard_normal((3, 32)).astype(np.float32)
    for idx in (port, ref):
        for i in range(3):
            idx.add(Node(id=5000 + i, embedding=fresh[i]))
        for i in (10, 11, 12):
            idx.delete(i)
    port._rebuild_device_tables()
    ref._rebuild_device_tables()
    np.testing.assert_allclose(port._rp_dev.numpy(), np.asarray(ref._rp_dev),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port._cells_xsq_dev.numpy(),
                               np.asarray(ref._cells_xsq_dev), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(port._cells_rp_dev.float().numpy(),
                               np.asarray(ref._cells_rp_dev, np.float32),
                               rtol=1e-2, atol=1e-2)
    flat, u = port._rp_flat_tables()
    jflat, ju = ref._rp_flat_tables()
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(flat.float().numpy(),
                               np.asarray(jflat, np.float32), rtol=1e-2,
                               atol=1e-2)
    for ratio, n_probe in ((None, 3), (0.0, 8), (1.0, 8)):
        if ratio is not None:
            port._rp_res_ratio = ratio
        _, own = port.search_batch(fresh, n_probe=n_probe, top_k=1, rp=True)
        np.testing.assert_array_equal(own[:, 0], [5000, 5001, 5002])
        _, ids = port.search_batch(x[10:13], n_probe=n_probe, top_k=5,
                                   rp=True)
        assert not set(ids.ravel().tolist()) & {10, 11, 12}


def test_rp_scan_tile_cap_matches_jax():
    """The cell-block scan keeps JAX's per-tile cap
    min(max(top_k, fetch // min(4, tiles)), tile): with many small tiles
    (ctile 2 of 32 cells) the un-reranked candidate lists equal JAX's."""
    from vector_db_tpu.index.ivf import _ivf_rp_scan_cells as jax_scan
    import jax.numpy as jnp

    x = _lowrank(2000, seed=8)
    q = _lowrank(12, seed=9)
    ref, port = _rp_pair(x, 32)
    ref._rebuild_device_tables()
    port._rebuild_device_tables()
    for fetch in (40, 200):
        want = jax_scan(ref._centroids_dev, ref._lists_dev,
                        ref._cells_rp_dev, ref._cells_xsq_dev, ref._emb,
                        ref._has_emb, jnp.asarray(q), ref._rp_proj_dev,
                        ref._rp_mu_dev, top_k=fetch, fetch=fetch,
                        rerank=False, dedup=False, ctile=2, qblock=8)
        got = ivf_mod._ivf_rp_scan_cells(
            port._centroids_dev, port._lists_dev, port._cells_rp_dev,
            port._cells_xsq_dev, port._emb, port._has_emb,
            ivf_mod.torch.from_numpy(q), port._rp_proj_dev, port._rp_mu_dev,
            top_k=fetch, fetch=fetch, rerank=False, dedup=False, ctile=2,
            qblock=8)
        gi, wi = got[1].numpy(), np.asarray(want[1])
        same = np.mean([set(a) == set(b) for a, b in zip(gi.tolist(),
                                                        wi.tolist())])
        assert same >= 0.9, same
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-4)


PQ_CASES = [dict(residual=True, spill=1), dict(residual=False, spill=1),
            dict(residual=False, spill=2)]


def _pq_pair(x, k, residual, spill, opq_iters=0):
    ref = JaxIvf(k=k)
    ref.build_arrays(range(x.shape[0]), x, seed=0, iters=10, spill=spill)
    ref.enable_pq(chunks=8, ksub=32, residual=residual, opq_iters=opq_iters)
    return ref, _carry(ref)


@pytest.mark.parametrize("case", PQ_CASES,
                         ids=lambda c: f"residual{int(c['residual'])}-"
                                       f"spill{c['spill']}")
def test_pq_scan_matches_jax(case):
    """n_probe >= k: the full-scan IVF-PQ on the adc_topk kernel's plain
    version against JAX's one-hot scan: the same id sets and exact
    distances, filtered and not, fetch at 64 and 300."""
    x = _gauss(2000, 32, 10)
    q = _gauss(24, 32, 11)
    ref, port = _pq_pair(x, 16, **case, opq_iters=2 if case["residual"]
                         else 0)
    allowed = set(range(1, 2000, 2))
    for kw in (dict(fetch=64), dict(fetch=300), dict(fetch=64,
                                                     filter_ids=allowed)):
        got = port.search_batch(q, n_probe=16, top_k=10, pq=True, **kw)
        want = ref.search_batch(q, n_probe=16, top_k=10, pq=True, **kw)
        _agree(got, want)
        ids = got[1]
        assert all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum())
                   for r in ids)
        if "filter_ids" in kw:
            assert set(ids[ids >= 0].tolist()) <= allowed


def _full_scan_case(route):
    """(JAX index, port, queries, search kwargs) of a full scan whose fetch
    runs past its kernel's lists: the flat RP route at top_k 100 (the
    default fetch 400 > 256) or the PQ full scan at fetch 2560 (> 2048)."""
    if route == "rp-flat":
        data = _lowrank(3000 + 24, seed=21)
        ref, port = _rp_pair(data[:3000], 16)
        ref._rp_res_ratio = port._rp_res_ratio = 1.0
        return ref, port, data[3000:], dict(n_probe=16, top_k=100, rp=True)
    x = _gauss(3000, 32, 22)
    ref, port = _pq_pair(x, 16, residual=True, spill=1)
    return ref, port, _gauss(12, 32, 23), dict(n_probe=16, top_k=10,
                                               pq=True, fetch=2560)


@pytest.mark.parametrize("route", ["rp-flat", "pq-scan"])
def test_full_scans_answer_past_kernel_lists(route):
    """Both full scans answer at a fetch above their kernel's lists, as the
    JAX package does, with JAX's id sets and distances within 1e-5."""
    ref, port, q, kw = _full_scan_case(route)
    (dg, ig), (dw, iw) = port.search_batch(q, **kw), ref.search_batch(q, **kw)
    assert ig.shape == iw.shape == (q.shape[0], kw["top_k"])
    for r in range(q.shape[0]):
        assert set(ig[r].tolist()) == set(iw[r].tolist()), r
        order_g, order_w = np.argsort(ig[r]), np.argsort(iw[r])
        np.testing.assert_allclose(dg[r][order_g], dw[r][order_w],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["rp-flat", "pq-scan"])
def test_full_scan_picks_kernel_or_plain_by_fetch(route, monkeypatch):
    """On the CPU the full scans call the kernel's wrapper up to its lists
    (256 for the flat route's l2_topk, 2048 for adc_topk) and the plain
    version past them. On a CUDA tensor the wrapper launches the kernel,
    and past its lists passes of it run (test_torch_cuda.py), so every
    fetch answers on the card as here."""
    from vector_db_tpu_torch.ops import exact as exact_mod

    ref, port, q, kw = _full_scan_case(route)
    mod, names = ((exact_mod, ("l2_topk", "l2_topk_plain"))
                  if route == "rp-flat" else
                  (ivf_mod, ("adc_topk", "adc_topk_plain")))
    calls = []
    for name in names:
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    limit = 256 if route == "rp-flat" else 2048
    for fetch, want in ((limit, names[0]), (limit + 1, names[1])):
        calls.clear()
        port.search_batch(q, **{**kw, "fetch": fetch})
        assert calls == [want], (fetch, calls)


@pytest.mark.parametrize("residual", [True, False])
def test_pq_scan_unreranked_estimates_match_jax(residual):
    """Pre-rerank values: the kernel's plain version (LUT sum + row term +
    group term, f32) against JAX's hi/lo bf16 contraction, within 2^-16 of
    the LUT sum's size; ids equal where values are apart."""
    import jax.numpy as jnp

    from tests.torch_parity import assert_topk_parity

    x = _gauss(1500, 32, 12)
    q = _gauss(10, 32, 13)
    ref, port = _pq_pair(x, 16, residual=residual, spill=1)
    cs, cc, cx = ref._device_cells()
    want = jax_pq_scan(ref._centroids_dev, cs, cc, cx, ref._pq.codebooks,
                       ref._emb, ref._has_emb, jnp.asarray(q),
                       ref._pq.rotate_queries(jnp.asarray(q)), top_k=41,
                       fetch=41, rerank=False, residual=residual,
                       dedup=False, ctile=4, qblock=8)
    ps, pc, px = port._device_cells()
    got = ivf_mod._ivf_pq_scan_cells(
        port._centroids_dev, ps, pc, px, port._pq.codebooks, port._emb,
        port._has_emb, ivf_mod.torch.from_numpy(q),
        port._pq.rotate_queries(q), top_k=40, fetch=40, rerank=False,
        residual=residual, dedup=False)
    lut_size = np.abs(np.asarray(want[0])).max()
    assert_topk_parity(got[0], got[1], want[0], want[1], rtol=2.0 ** -16,
                       atol=1e-4, scale=lut_size, extra=1)


def test_independent_training_recall_within_001():
    """Both packages train their own projection (enable_rp) on one corpus:
    the three routes' recall@10 against brute force agree within 0.01."""
    data = _lowrank(4000 + 64, seed=14)
    x, q = data[:4000], data[4000:]
    gt = np.argsort(((x[None] - q[:, None]) ** 2).sum(-1), 1)[:, :10]
    ref = JaxIvf(k=32)
    ref.build_arrays(range(4000), x, seed=0, iters=10)
    port = IvfIndex(k=32, device="cpu")
    port.load_state(np.asarray(ref._store.emb), np.asarray(ref._store.valid),
                    ref._store.export_id_map(), ref.centroids,
                    ref.inverted_lists)
    ref.enable_rp(dims=16)
    port.enable_rp(dims=16)
    assert abs(port._rp_res_ratio - ref._rp_res_ratio) < 1e-4
    for n_probe, ratio in ((6, None), (32, 0.0), (32, 1.0)):
        if ratio is not None:
            ref._rp_res_ratio = port._rp_res_ratio = ratio
        r_port = recall(port.search_batch(q, n_probe, 10, rp=True)[1], gt)
        r_ref = recall(ref.search_batch(q, n_probe, 10, rp=True)[1], gt)
        assert abs(r_port - r_ref) <= 0.01, (n_probe, r_port, r_ref)


# -- the JAX package's contracts (tests/index/test_ivf_scale.py:220-365,
# test_ivf.py:155), on the port ----------------------------------------
def test_rp_matches_exact_probe_recall():
    data = _lowrank(4096 + 32)
    x, q = data[:4096], data[4096:]
    ivf = IvfIndex(k=32, device="cpu")
    ivf.build_arrays(range(4096), x, seed=0, iters=15)
    ivf.enable_rp(dims=16)
    _, ids_rp = ivf.search_batch(q, n_probe=8, top_k=10, rp=True, fetch=64)
    _, ids_ex = ivf.search_batch(q, n_probe=8, top_k=10)
    assert recall(ids_rp, ids_ex) >= 0.95


def test_rp_add_after_enable():
    x = _clustered(512, 32, 3)
    ivf = IvfIndex(k=8, device="cpu")
    ivf.build_arrays(range(len(x)), x, seed=1, iters=10, spill=2)
    ivf.enable_rp(dims=16)
    v = x[7] + np.random.default_rng(9).standard_normal(32).astype(
        np.float32)
    ivf.add(Node(id=10_000, embedding=v.tolist(), metadata={}))
    d, ids = ivf.search_batch(v[None, :], n_probe=8, top_k=1, rp=True)
    assert ids[0, 0] == 10_000
    assert d[0, 0] < 0.5


@pytest.mark.parametrize("spill", [1, 2])
def test_rp_scan_mode_full_probe(spill):
    data = _lowrank(4096 + 32, seed=7)
    x, q = data[:4096], data[4096:]
    gt = np.argsort(((x[None] - q[:, None]) ** 2).sum(-1), 1)[:, :10]
    ivf = IvfIndex(k=32, device="cpu")
    ivf.build_arrays(range(4096), x, seed=0, iters=15, spill=spill)
    ivf.enable_rp(dims=16)
    _, ids = ivf.search_batch(q, n_probe=32, top_k=10, rp=True, fetch=64)
    assert recall(ids, gt) >= 0.97
    assert all(len(set(r[r >= 0].tolist())) == int((r >= 0).sum())
               for r in ids)


def test_pq_scan_mode_full_probe():
    x = _clustered(4096, 64, 13)
    q = _clustered(32, 64, 14)
    gt = np.argsort(((x[None] - q[:, None]) ** 2).sum(-1), 1)[:, :10]
    ivf = IvfIndex(k=32, device="cpu")
    ivf.build_arrays(range(4096), x, seed=0, iters=15)
    ivf.enable_pq(chunks=8, ksub=64, residual=True)
    _, ids_scan = ivf.search_batch(q, n_probe=32, top_k=10, pq=True,
                                   fetch=128)
    _, ids_probe = ivf.search_batch(q, n_probe=31, top_k=10, pq=True,
                                    fetch=128)
    assert recall(ids_scan, gt) >= recall(ids_probe, gt) - 0.02
    assert recall(ids_scan, gt) >= 0.9


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_persistence_restores_rp_and_pq(tmp_path, writer):
    """save_index / load_index carry the projection and mean with the PQ
    state: a reopened index serves rp and pq with no retraining and the
    same answers; the npz loads in the other package too."""
    x = _clustered(2048, 32, 31)
    storage = InMemoryNodeStorage()
    for i in range(2048):
        storage.save(Node(id=i, embedding=x[i], metadata={}))
    path = tmp_path / "ivf.npz"
    make = (lambda: JaxIvf(k=16, storage=storage, index_file=path)) \
        if writer == "jax" else \
        (lambda: IvfIndex(k=16, storage=storage, index_file=path,
                          device="cpu"))
    ivf = make()
    ivf.autosave = False
    ivf.build_arrays(range(2048), x, seed=0, iters=10)
    ivf.enable_pq(chunks=4, ksub=32, residual=True, opq_iters=2)
    ivf.enable_rp(dims=16)
    ivf.save_index()
    q = x[:16] + 0.01
    want = {m: ivf.search_batch(q, n_probe=8, top_k=5, **{m: True})[1]
            for m in ("pq", "rp")}
    again = make()
    port = IvfIndex(k=16, storage=storage, index_file=path, device="cpu")
    for idx in (again, port):
        assert idx._pq is not None and idx._rp_proj is not None
        for m in ("pq", "rp"):
            got = idx.search_batch(q, n_probe=8, top_k=5, **{m: True})[1]
            assert recall(got, want[m]) >= 0.99, (m, idx)
    np.testing.assert_allclose(port._rp_proj, ivf._rp_proj)


def test_ivf_rp_filter_ids():
    rng = np.random.default_rng(0)
    n, dim = 400, 24
    x = rng.standard_normal((n, dim)).astype(np.float32)
    index = IvfIndex(k=8, device="cpu")
    index.build_index([Node(id=i, embedding=x[i]) for i in range(n)])
    index.enable_rp(dims=dim)
    allowed = set(int(i) for i in rng.choice(n, 120, replace=False))
    q = rng.standard_normal((5, dim)).astype(np.float32)
    for n_probe in (4, 8):
        _, ids = index.search_batch(q, n_probe=n_probe, top_k=5, rp=True,
                                    filter_ids=allowed, fetch=128)
        assert set(ids[ids >= 0].tolist()) <= allowed
    al = np.asarray(sorted(allowed))
    want = al[np.argsort(((q[:, None] - x[al][None]) ** 2).sum(-1),
                         1)[:, :5]]
    _, ids = index.search_batch(q, n_probe=8, top_k=5, rp=True,
                                filter_ids=allowed, fetch=128)
    for i in range(5):
        assert set(ids[i][ids[i] >= 0].tolist()) == set(want[i].tolist())


def test_rp_errors_match_jax():
    x = _gauss(100, 16, 2)
    for make in (lambda: JaxIvf(k=4), lambda: IvfIndex(k=4, device="cpu")):
        idx = make()
        with pytest.raises(ValueError, match="built"):
            idx.enable_rp()
        idx.build_arrays(range(100), x, iters=3)
        with pytest.raises(ValueError, match="enable_rp"):
            idx.search_batch(x[:2], 2, 3, rp=True)
        with pytest.raises(ValueError, match="positive"):
            idx.enable_rp(dims=0)
