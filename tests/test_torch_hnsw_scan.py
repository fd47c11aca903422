"""HNSW.search_batch_scan and ops.exact.block_select_search on the port,
held against the JAX package on the CPU, on a JAX graph and table carried
over with ``load_state`` (n = 3000, d = 48).

- ``exact``: ids equal to JAX's, distances within 1e-5 relative.
- ``bf16`` and ``blocksel``: recall@10 against the f32 exact scan no more
  than 0.005 under JAX's (JAX selects the bf16 candidates with
  ``approx_min_k``, the port exactly, so ids are held by recall).
- ``filter_ids`` folds into the validity mask; a mutation between two
  scans rebuilds the mirror; k = 10 and k = 16 agree on their first 10
  ids (k is rounded up before the exact rescore in both packages).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tests.torch_parity import assert_topk_parity, recall
from tests.torch_parity import one_torch_thread  # noqa: F401

from vector_db_tpu.index.hnsw import HNSW as JaxHNSW
from vector_db_tpu.ops.exact import block_select_search as jax_block_select
from vector_db_tpu_torch.index.hnsw import HNSW
from vector_db_tpu_torch.ops.exact import block_select_search
from vector_db_tpu_torch.types import Node

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, DIM, B, K = 3000, 48, 64, 10
RECALL_TOL = 0.005


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    q = rng.normal(size=(B, DIM)).astype(np.float32)
    ref = JaxHNSW(M=8, ef_construction=60, rng=random.Random(42), capacity=N,
                  l_max=4)
    ref.bulk_build(list(range(N)), x)
    port = HNSW(M=8, ef_construction=60, rng=random.Random(0), l_max=4,
                device="cpu")
    g = ref.graph
    port.load_state(np.asarray(g.neighbors), np.asarray(g.levels),
                    int(g.entry), int(g.entry_level),
                    np.asarray(ref._store.emb), np.asarray(ref._store.valid),
                    ref._store.export_id_map())
    return ref, port, x, q


def _truth(x, q, k=K, allowed=None):
    ids = np.arange(len(x)) if allowed is None else np.asarray(sorted(allowed))
    d = ((q[:, None].astype(np.float64) - x[ids][None]) ** 2).sum(-1)
    return ids[np.argsort(d, 1)[:, :k]]


def test_exact_scan_ids_equal_jax(pair):
    ref, port, x, q = pair
    d_want, i_want = ref.search_batch_scan(q, K, mode="exact")
    d_got, i_got = port.search_batch_scan(q, K, mode="exact")
    assert_topk_parity(d_got ** 2, i_got, d_want ** 2, i_want,
                       scale=(q * q).sum(1) + 2 * DIM)
    np.testing.assert_array_equal(i_got, i_want)
    np.testing.assert_array_equal(i_got, _truth(x, q))


@pytest.mark.parametrize("mode", ["bf16", "blocksel"])
def test_approximate_scans_recall_near_jax(pair, mode):
    ref, port, x, q = pair
    truth = _truth(x, q)
    d_got, i_got = port.search_batch_scan(q, K, mode=mode)
    want = recall(ref.search_batch_scan(q, K, mode=mode)[1], truth)
    got = recall(i_got, truth)
    assert got >= want - RECALL_TOL, (mode, got, want)
    # the reported distances are the exact L2 of each id, ascending
    d64 = np.sqrt(((x[i_got] - q[:, None]) ** 2).sum(-1))
    np.testing.assert_allclose(d_got, d64, rtol=1e-5, atol=1e-5)
    assert (np.diff(d_got, axis=1) >= 0).all()


@pytest.mark.parametrize("mode", ["bf16", "exact", "blocksel"])
def test_filtered_scan_stays_in_filter(pair, mode):
    ref, port, x, q = pair
    allowed = set(range(0, N, 7))
    _, ids = port.search_batch_scan(q, K, mode=mode, filter_ids=allowed)
    assert set(ids.ravel().tolist()) <= allowed
    truth = _truth(x, q, allowed=allowed)
    want = recall(ref.search_batch_scan(q, K, mode=mode,
                                        filter_ids=allowed)[1], truth)
    assert recall(ids, truth) >= want - RECALL_TOL


@pytest.mark.parametrize("mode", ["bf16", "exact", "blocksel"])
def test_k10_and_k16_agree_on_their_first_ids(pair, mode):
    _, port, _, q = pair
    d10, i10 = port.search_batch_scan(q, 10, mode=mode)
    d16, i16 = port.search_batch_scan(q, 16, mode=mode)
    assert i10.shape == (B, 10) and i16.shape == (B, 16)
    np.testing.assert_array_equal(i10, i16[:, :10])
    np.testing.assert_array_equal(d10, d16[:, :10])


def test_mutation_between_scans_rebuilds_the_mirror():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    idx = HNSW(M=4, ef_construction=30, rng=random.Random(1), device="cpu")
    idx.bulk_build(range(300), x)
    probe = rng.normal(size=(1, 16)).astype(np.float32)
    _, before = idx.search_batch_scan(probe, 3)
    mirror = idx._scan_mirror()
    assert idx._scan_mirror()[0] is mirror[0]   # cached until a mutation
    idx.insert_nodes([Node(id=999, embedding=probe[0])])
    for mode in ("bf16", "exact", "blocksel"):
        d, ids = idx.search_batch_scan(probe, 3, mode=mode)
        assert ids[0, 0] == 999 and d[0, 0] == pytest.approx(0.0, abs=1e-5)
    emb16, x_sq = idx._scan_mirror()
    assert emb16 is not mirror[0] and idx._scan_sq[0] == idx._version
    torch.testing.assert_close(emb16, idx._emb.to(torch.bfloat16))
    torch.testing.assert_close(x_sq, (idx._emb * idx._emb).sum(1))
    idx.delete_node(999)
    for mode in ("bf16", "exact", "blocksel"):
        _, ids = idx.search_batch_scan(probe, 3, mode=mode)
        assert 999 not in ids
        np.testing.assert_array_equal(ids, before)
    assert idx.search_batch_scan(probe, 3)[1].shape == (1, 3)
    with pytest.raises(ValueError, match="scan mode"):
        idx.search_batch_scan(probe, 3, mode="pq")
    empty = HNSW(M=4, ef_construction=30, rng=random.Random(1), device="cpu")
    d, ids = empty.search_batch_scan(probe, 3)
    assert (ids == -1).all() and np.isinf(d).all()


@pytest.mark.parametrize("phase1", ["default", "exact_phase1",
                                    "hilo_phase1"])
def test_block_select_search_matches_jax(phase1):
    """The plain function against JAX's on one f32 table and its bf16
    mirror (a ragged corpus, invalid rows, a tile that pads): with an f32
    phase 1 the result is the exact top-k in both; ids are equal to JAX's
    wherever distances are apart."""
    rng = np.random.default_rng(5)
    n, d, b, k = 1000, 32, 40, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    valid = rng.random(n) > 0.1
    x_sq = (x * x).sum(1)
    tab = x if phase1 != "default" else x.astype(jnp.bfloat16)
    kw = {phase1: True} if phase1 != "default" else {}
    want = jax_block_select(jnp.asarray(q), jnp.asarray(tab), jnp.asarray(q),
                            jnp.asarray(x_sq), jnp.asarray(x),
                            jnp.asarray(valid), k, tile=256, **kw)
    t_tab = (torch.from_numpy(x) if phase1 != "default"
             else torch.from_numpy(x).to(torch.bfloat16))
    got = block_select_search(torch.from_numpy(q), t_tab, torch.from_numpy(q),
                              torch.from_numpy(x_sq), torch.from_numpy(x),
                              torch.from_numpy(valid), k, tile=256, **kw)
    assert_topk_parity(got[0], got[1], np.asarray(want[0]),
                       np.asarray(want[1]), scale=(q * q).sum(1) + 2 * d)
    if phase1 != "default":
        live = np.flatnonzero(valid)
        dd = ((q[:, None] - x[live][None]) ** 2).sum(-1)
        np.testing.assert_array_equal(
            got[1].numpy(), live[np.argsort(dd, 1)[:, :k]])


def test_block_select_search_approx_blocks_raises():
    x = torch.zeros((256, 8))
    with pytest.raises(NotImplementedError, match="approx_min_k"):
        block_select_search(x[:2], x, x[:2], x[:, 0], x,
                            torch.ones(256, dtype=torch.bool), 4, tile=256,
                            approx_blocks=True)
