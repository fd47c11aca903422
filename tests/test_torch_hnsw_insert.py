"""The port's HNSW streaming insert against the JAX package's on the CPU.

- The edge commits (``commit_inserts``, ``commit_inserts_grouped``) on the
  JAX package's own candidates and intra-batch distances give its
  neighbor table, levels, entry and entry level bit for bit: several batch
  sizes, padded slots (-1), an empty graph, random pre-existing graphs.
- ``construction_candidates_exact`` gives the same id set per (point,
  level) with distances within 1e-5 relative (on the CPU the JAX scan's
  ``approx_min_k`` is exact); ``construction_search`` the same sets.
- A bulk build followed by three streamed batches in both packages, from
  one ``random.Random`` seed: equal levels and entry, neighbor rows equal
  as sets on >= 99 % of rows, recall@10 within 0.01.
- The contracts of tests/index/test_hnsw.py and test_commit_grouped.py on
  the port, and a recall check at the settings of
  tests/index/test_reference_parity.py at a reduced size (the port within
  0.02, that file's tolerance, of the JAX package's recall).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import t
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.index import hnsw_kernels as JK
from vector_db_tpu.index.hnsw import HNSW as JaxHNSW
from vector_db_tpu_torch.index import hnsw_kernels as K
from vector_db_tpu_torch.index.hnsw import HNSW
from vector_db_tpu_torch.types import Node

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _levels(pyr, n, M, l_max):
    return np.asarray([min(int(-np.log(pyr.random()) / np.log(M)), l_max - 1)
                       for _ in range(n)], np.int32)


def _jax_graph(cap, M, l_max):
    return JK.Graph(neighbors=jnp.full((cap, K.ncols(M, l_max)), -1,
                                       jnp.int32),
                    levels=jnp.full((cap,), -1, jnp.int32),
                    entry=jnp.int32(-1), entry_level=jnp.int32(-1))


def _port_graph(jg):
    return K.Graph(neighbors=t(np.asarray(jg.neighbors)).clone(),
                   levels=t(np.asarray(jg.levels)).clone(),
                   entry=int(jg.entry), entry_level=int(jg.entry_level))


def _pair_dists(a):
    return ((a[:, None] - a[None]) ** 2).sum(-1).astype(np.float32)


def _seed_graph(seed, M, l_max, cap, n0, dim, efc, batch):
    """A JAX graph of n0 committed rows (the sequential commit on beam
    candidates, as tests/index/test_commit_reference.py makes it), the
    table with the batch's rows valid after them, and the batch's slots
    and levels."""
    rng = np.random.default_rng(seed)
    pyr = random.Random(seed)
    emb = rng.standard_normal((cap, dim)).astype(np.float32)
    has = np.zeros(cap, bool)
    has[:n0 + batch] = True
    graph = _jax_graph(cap, M, l_max)
    if n0:
        lvl0 = _levels(pyr, n0, M, l_max)
        cd, cs = JK.construction_search(
            graph, jnp.asarray(emb), jnp.asarray(has), jnp.asarray(emb[:n0]),
            jnp.asarray(lvl0), M=M, l_max=l_max, ef_construction=efc,
            max_steps=2 * efc + 16)
        graph = JK.commit_inserts(
            graph, jnp.asarray(emb), jnp.asarray(has),
            jnp.arange(n0, dtype=jnp.int32), jnp.asarray(lvl0), cd, cs,
            jnp.asarray(_pair_dists(emb[:n0])), M=M, l_max=l_max,
            ef_construction=efc)
    slots = np.arange(n0, n0 + batch, dtype=np.int32)
    lvls = _levels(pyr, batch, M, l_max)
    return emb, has, graph, slots, lvls


# (seed, M, l_max, n0, batch, padded items, candidates)
COMMIT_CASES = [
    (0, 4, 3, 20, 7, (), "beam"),
    (1, 8, 2, 20, 5, (), "beam"),
    (2, 4, 3, 40, 16, (3, 9, 15), "exact"),
    (3, 8, 3, 0, 12, (), "beam"),          # an empty graph
    (4, 4, 4, 60, 33, (0, 32), "exact"),
    (5, 16, 3, 60, 64, (), "exact"),
]


@pytest.mark.parametrize("commit", ["grouped", "sequential"])
@pytest.mark.parametrize("case", COMMIT_CASES,
                         ids=[f"case{i}" for i in range(len(COMMIT_CASES))])
def test_commit_equals_jax_bit_for_bit(commit, case):
    seed, M, l_max, n0, batch, padded, cands = case
    cap, dim, efc = 128, 8, 2 * M + 4
    emb, has, graph, slots, lvls = _seed_graph(seed, M, l_max, cap, n0, dim,
                                               efc, batch)
    slots[list(padded)] = -1
    jemb, jhas = jnp.asarray(emb), jnp.asarray(has)
    new = jnp.asarray(emb[n0:n0 + batch])
    if cands == "beam":
        cd, cs = JK.construction_search(
            graph, jemb, jhas, new, jnp.asarray(lvls), M=M, l_max=l_max,
            ef_construction=efc, max_steps=2 * efc + 16)
    else:
        cd, cs = JK.construction_candidates_exact(
            graph, jemb, jhas, new, l_max=l_max, ef_construction=efc,
            ef_upper=8, tile=cap)
    bd = _pair_dists(emb[n0:n0 + batch])
    port_g = _port_graph(graph)   # before the call: JAX donates the graph
    cd_np, cs_np = np.asarray(cd), np.asarray(cs)
    jax_fn = (JK.commit_inserts_grouped if commit == "grouped"
              else JK.commit_inserts)
    want = jax_fn(graph, jemb, jhas, jnp.asarray(slots), jnp.asarray(lvls),
                  cd, cs, jnp.asarray(bd), M=M, l_max=l_max,
                  ef_construction=efc)
    port_fn = (K.commit_inserts_grouped if commit == "grouped"
               else K.commit_inserts)
    got = port_fn(port_g, t(emb), t(has), t(slots), t(lvls), t(cd_np),
                  t(cs_np), t(bd), M=M, l_max=l_max, ef_construction=efc)
    np.testing.assert_array_equal(got.levels.numpy(), np.asarray(want.levels))
    assert (got.entry, got.entry_level) == (int(want.entry),
                                            int(want.entry_level))
    np.testing.assert_array_equal(got.neighbors.numpy(),
                                  np.asarray(want.neighbors))
    assert (got.neighbors.numpy() >= 0).sum() > 0


def test_commit_keeps_jax_order_on_tied_distances():
    """Duplicate rows tie in every distance: the stable selection keeps
    the JAX package's (lax.top_k's) order, so the tables stay equal."""
    M, l_max, cap, efc, n0, batch = 4, 2, 64, 12, 24, 10
    emb, has, graph, slots, lvls = _seed_graph(6, M, l_max, cap, n0, 8, efc,
                                               0)
    emb[n0:n0 + batch] = emb[3]          # the batch: copies of row 3
    emb[n0 + 2] = emb[5]
    has[:n0 + batch] = True
    slots = np.arange(n0, n0 + batch, dtype=np.int32)
    lvls = np.zeros(batch, np.int32)
    jemb, jhas = jnp.asarray(emb), jnp.asarray(has)
    cd, cs = JK.construction_candidates_exact(
        graph, jemb, jhas, jnp.asarray(emb[n0:n0 + batch]), l_max=l_max,
        ef_construction=efc, ef_upper=8, tile=cap)
    bd = _pair_dists(emb[n0:n0 + batch])
    port_g = _port_graph(graph)
    cd_np, cs_np = np.asarray(cd), np.asarray(cs)
    want = JK.commit_inserts_grouped(
        graph, jemb, jhas, jnp.asarray(slots), jnp.asarray(lvls), cd, cs,
        jnp.asarray(bd), M=M, l_max=l_max, ef_construction=efc)
    got = K.commit_inserts_grouped(port_g, t(emb), t(has), t(slots),
                                   t(lvls), t(cd_np), t(cs_np), t(bd), M=M,
                                   l_max=l_max, ef_construction=efc)
    np.testing.assert_array_equal(got.neighbors.numpy(),
                                  np.asarray(want.neighbors))


@pytest.mark.parametrize("efc,ef_upper", [(12, 8), (40, 64), (300, 64)])
def test_construction_candidates_exact_match_jax(efc, ef_upper):
    """Per (point, level) the same id set, distances within 1e-5 relative;
    efc = 300 takes the l2 scan past l2_topk's k of 256 (on the CPU the
    tiled plain scan, on a CUDA device passes of the kernel)."""
    M, l_max, cap, n0, batch = 4, 4, 512, 400, 24
    emb, has, graph, slots, lvls = _seed_graph(7, M, l_max, cap, n0, 16, 24,
                                               batch)
    new = emb[n0:n0 + batch]
    want_d, want_s = JK.construction_candidates_exact(
        graph, jnp.asarray(emb), jnp.asarray(has), jnp.asarray(new),
        l_max=l_max, ef_construction=efc, ef_upper=ef_upper, tile=cap)
    want_d, want_s = np.asarray(want_d), np.asarray(want_s)
    got_d, got_s = K.construction_candidates_exact(
        _port_graph(graph), t(emb), t(has), t(new), l_max=l_max,
        ef_construction=efc, ef_upper=ef_upper)
    got_d, got_s = got_d.numpy(), got_s.numpy()
    assert got_d.shape == got_s.shape == (batch, l_max, efc)
    # the batch's rows are valid but uncommitted: never a candidate
    assert not np.isin(got_s, np.arange(n0, n0 + batch)).any()
    per_level = [int((np.asarray(graph.levels) >= lv).sum())
                 for lv in range(l_max)]
    for lv in range(l_max):
        k = min(efc if lv == 0 else min(ef_upper, efc), per_level[lv])
        assert (got_s[:, lv, :k] >= 0).all() and (got_s[:, lv, k:] < 0).all()
        for b in range(batch):
            assert set(got_s[b, lv]) == set(want_s[b, lv]), (lv, b)
        live = want_s[:, lv] >= 0
        np.testing.assert_allclose(got_d[:, lv][live], want_d[:, lv][live],
                                   rtol=1e-5, atol=1e-5)


def test_construction_search_matches_jax():
    M, l_max, cap, n0, batch, efc = 8, 4, 512, 400, 24, 32
    emb, has, graph, slots, lvls = _seed_graph(8, M, l_max, cap, n0, 16, 24,
                                               batch)
    lvls[:4] = [3, 2, 1, 1]           # some points above level 0
    new = emb[n0:n0 + batch]
    want_d, want_s = JK.construction_search(
        graph, jnp.asarray(emb), jnp.asarray(has), jnp.asarray(new),
        jnp.asarray(lvls), M=M, l_max=l_max, ef_construction=efc,
        max_steps=2 * efc + 16, expand=4)
    want_s = np.asarray(want_s)
    got_d, got_s = K.construction_search(
        _port_graph(graph), t(emb), t(has), t(new), t(lvls), M=M,
        l_max=l_max, ef_construction=efc, max_steps=2 * efc + 16, expand=4)
    got_s = got_s.numpy()
    same = np.mean([set(got_s[b, lv]) == set(want_s[b, lv])
                    for b in range(batch) for lv in range(l_max)])
    assert same >= 0.99, same
    for b in range(batch):   # levels above min(target, entry level): empty
        start = min(int(lvls[b]), int(graph.entry_level))
        assert (got_s[b, start + 1:] < 0).all()
        assert (got_d[b, start + 1:].numpy() >= 1e37).all()
        assert (got_s[b, :start + 1, 0] >= 0).all()


def _rows_as_sets(idx, table):
    levels = idx._levels_host
    out = {}
    for slot in np.nonzero(levels >= 0)[0]:
        for lv in range(levels[slot] + 1):
            s = K.level_col_start(lv, idx.M)
            row = table[slot, s:s + K.level_width(lv, idx.M)]
            out[(int(slot), lv)] = frozenset(int(v) for v in row if v >= 0)
    return out


def _recall(ids, gt):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                          for a, b in zip(ids, gt)]))


@pytest.mark.parametrize("mode,commit", [("exact", "grouped"),
                                         ("beam", "grouped"),
                                         ("exact", "sequential")])
def test_stream_after_bulk_build_matches_jax(mode, commit):
    """bulk_build of 1,400 rows, then three streamed batches of 200 (the
    last through insert_nodes), from the same random.Random seed."""
    rng = np.random.default_rng(9)
    n0, n, dim, M, l_max = 1400, 2000, 32, 8, 4
    x = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((40, dim)).astype(np.float32)
    pair = []
    for cls, kw in ((JaxHNSW, {}), (HNSW, {"device": "cpu"})):
        idx = cls(M=M, ef_construction=60, rng=random.Random(5),
                  capacity=2048, l_max=l_max, **kw)
        idx.construction_mode, idx.commit_mode = mode, commit
        idx.bulk_build(range(n0), x[:n0])
        idx.insert_arrays(range(n0, n0 + 200), x[n0:n0 + 200])
        idx.insert_arrays(range(n0 + 200, n0 + 400), x[n0 + 200:n0 + 400],
                          batch_size=128)
        idx.insert_nodes([Node(id=i, embedding=x[i])
                          for i in range(n0 + 400, n)])
        pair.append(idx)
    ref, port = pair
    np.testing.assert_array_equal(port.graph.levels.numpy(),
                                  np.asarray(ref.graph.levels))
    np.testing.assert_array_equal(port._levels_host, ref._levels_host)
    assert (port.graph.entry, port.graph.entry_level) == (
        int(ref.graph.entry), int(ref.graph.entry_level))
    a = _rows_as_sets(port, port.graph.neighbors.numpy())
    b = _rows_as_sets(ref, np.asarray(ref.graph.neighbors))
    assert a.keys() == b.keys()
    assert np.mean([a[key] == b[key] for key in a]) >= 0.99
    d = ((q[:, None] - x[None]) ** 2).sum(-1)
    gt = np.argsort(d, 1)[:, :10]
    r_port = _recall(port.search_batch(q, 10, ef=64)[1], gt)
    r_ref = _recall(np.asarray(ref.search_batch(q, 10, ef=64)[1]), gt)
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)


def test_streamed_recall_near_jax_at_reference_settings():
    """tests/index/test_reference_parity.py's settings (M = 16,
    ef_construction = 200, l_max = 5, insert_arrays in batches of 1024,
    isotropic gaussian rows) at 1,500 x 128 instead of 2,000 x 384: the
    port's recall@10 at ef 50 / 100 / 200 within 0.02 of JAX's."""
    rng = np.random.default_rng(0)
    n, dim = 1500, 128
    x = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((30, dim)).astype(np.float32)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), 1)[:, :10]
    recalls = []
    for cls, kw in ((JaxHNSW, {}), (HNSW, {"device": "cpu"})):
        idx = cls(M=16, ef_construction=200, rng=random.Random(42),
                  capacity=2048, l_max=5, **kw)
        idx.insert_arrays(list(range(n)), x, batch_size=1024)
        recalls.append([_recall(np.asarray(idx.search_batch(q, 10, ef=ef)[1]),
                                gt) for ef in (50, 100, 200)])
    for want, got in zip(*recalls):
        assert got >= want - 0.02, recalls
    assert recalls[1][-1] >= 0.9, recalls


# -- tests/index/test_hnsw.py and test_commit_grouped.py, on the port --------
def make_nodes(rng, n, dim):
    return [Node(id=i, embedding=rng.standard_normal(dim).astype(np.float32),
                 metadata={"i": i}) for i in range(n)]


def _hnsw(**kw):
    kw.setdefault("rng", random.Random(42))
    return HNSW(device="cpu", **kw)


def test_insert_and_size(rng):
    index = _hnsw(M=4, ef_construction=20)
    for node in make_nodes(rng, 20, 8):
        index.insert_node(node)
    assert index.size == 20 and index.storage.size() == 20


def test_self_query_and_connectivity(rng):
    nodes = make_nodes(rng, 100, 16)
    index = _hnsw(M=8, ef_construction=50)
    index.build_index(nodes)
    hit = index.search(nodes[17].embedding, k=1, ef=50)[0]
    assert hit[0].id == 17 and hit[1] < 1e-3
    seen, frontier = {index.entry_node_id}, [index.entry_node_id]
    while frontier:
        nxt = []
        for nid in frontier:
            for nb in index.neighbors_of(nid, 0):
                if nb not in seen:
                    seen.add(nb)
                    nxt.append(nb)
        frontier = nxt
    assert len(seen) >= 90


@pytest.mark.parametrize("batch_size", [100, 16])
def test_recall_vs_brute_force(rng, batch_size):
    nodes = make_nodes(rng, 100, 16)
    index = _hnsw(M=8, ef_construction=50)
    index.insert_nodes(nodes, batch_size=batch_size)
    ok = 0
    for _ in range(10):
        q = rng.standard_normal(16).astype(np.float32)
        got = {n.id for n, _ in index.search(q, k=5, ef=50)}
        d = np.array([np.linalg.norm(q - n.embedding) for n in nodes])
        ok += len(got & set(np.argsort(d)[:5].tolist())) / 5 >= 0.7
    assert ok >= 8


def test_idempotent_insert(rng):
    index = _hnsw(M=4, ef_construction=20)
    nodes = make_nodes(rng, 20, 8)
    index.build_index(nodes)
    index.insert_node(nodes[5])
    index.insert_node(nodes[5])
    assert index.size == 20
    assert index.search(nodes[5].embedding, k=1)[0][0].id == 5


def test_delete_entry_reelects_then_insert(rng):
    index = _hnsw(M=4, ef_construction=30)
    nodes = make_nodes(rng, 30, 8)
    index.build_index(nodes)
    entry = index.entry_node_id
    index.delete_node(entry)
    assert index.entry_node_id not in (entry, None)
    index.insert_node(Node(id=500, embedding=nodes[entry].embedding))
    assert index.search(nodes[entry].embedding, k=1)[0][0].id == 500
    assert len(index.search(nodes[3].embedding, k=3, ef=30)) == 3


def test_delete_all_then_insert(rng):
    index = _hnsw(M=4, ef_construction=20)
    nodes = make_nodes(rng, 5, 8)
    index.build_index(nodes)
    for node in nodes:
        index.delete_node(node.id)
    assert index.size == 0 and index.search(nodes[0].embedding, k=3) == []
    index.insert_node(Node(id=100, embedding=nodes[0].embedding))
    assert index.search(nodes[0].embedding, k=1)[0][0].id == 100


def test_capacity_growth(rng):
    index = _hnsw(M=4, ef_construction=20, capacity=8)
    nodes = make_nodes(rng, 40, 8)
    index.build_index(nodes)
    assert index.size == 40 and index._capacity >= 40
    assert index.graph.neighbors.shape[0] == index._capacity
    assert index._levels_host.shape == (index._capacity,)
    assert index.search(nodes[11].embedding, k=1, ef=30)[0][0].id == 11


def test_storage_deleted_node_skipped(rng):
    index = _hnsw(M=4, ef_construction=30)
    nodes = make_nodes(rng, 30, 8)
    index.build_index(nodes)
    index.storage.delete(12)
    index.sync_storage()
    assert all(n.id != 12 for n, _ in
               index.search(nodes[12].embedding, k=5, ef=30))


def test_duplicate_ids_within_batch(rng):
    index = _hnsw(M=4, ef_construction=20)
    v = rng.standard_normal(8).astype(np.float32)
    index.insert_nodes([Node(id=7, embedding=v),
                        Node(id=7, embedding=v + 0.01),
                        Node(id=8, embedding=rng.standard_normal(8).astype(
                            np.float32))])
    assert index.size == 2 and int(index._has_emb.sum()) == 2
    assert [n.id for n, _ in index.search(v, k=4, ef=20)].count(7) == 1
    index.delete_node(7)
    assert 7 not in [n.id for n, _ in index.search(v, k=4, ef=20)]


def test_duplicate_ids_insert_arrays(rng):
    index = _hnsw(M=4, ef_construction=20)
    index.insert_arrays([3, 3, 4, 4],
                        rng.standard_normal((4, 8)).astype(np.float32))
    assert index.size == 2 and int(index._has_emb.sum()) == 2


def test_delete_clears_incoming_edges(rng):
    index = _hnsw(M=4, ef_construction=30)
    for node in make_nodes(rng, 60, 8):
        index.insert_node(node)
    for victim in (13, 37, 5):
        slot = index._slot_of_id[victim]
        index.delete_node(victim)
        assert not (index.graph.neighbors == slot).any()


def test_levels_mirror_and_version_follow_inserts(rng):
    index = _hnsw(M=4, ef_construction=20)
    index.insert_nodes(make_nodes(rng, 40, 8), batch_size=16)
    np.testing.assert_array_equal(index._levels_host,
                                  index.graph.levels.numpy())
    before = index._version
    index.insert_arrays([100, 101], rng.standard_normal((2, 8)).astype(
        np.float32))
    assert index._version == before + 1   # one batch, one bump


def test_unknown_commit_mode_raises(rng):
    index = _hnsw(M=4, ef_construction=20)
    index.commit_mode = "nope"
    with pytest.raises(ValueError, match="commit"):
        index.insert_nodes(make_nodes(rng, 3, 8))


@pytest.mark.parametrize("batch_size", [1, 7, 32])
def test_grouped_matches_sequential(rng, batch_size):
    nodes = [Node(id=i, embedding=rng.standard_normal(12).astype(np.float32))
             for i in range(64)]
    built = []
    for mode in ("sequential", "grouped"):
        index = _hnsw(M=4, ef_construction=24)
        index.commit_mode = mode
        index.insert_nodes(nodes, batch_size=batch_size)
        built.append(index)
    a, b = built
    assert (a.graph.entry, a.graph.entry_level) == (b.graph.entry,
                                                    b.graph.entry_level)
    assert torch.equal(a.graph.levels, b.graph.levels)
    ra = _rows_as_sets(a, a.graph.neighbors.numpy())
    rb = _rows_as_sets(b, b.graph.neighbors.numpy())
    assert ra == rb
