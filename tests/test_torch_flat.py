"""The ported FlatIndex, end to end on the CPU, against the JAX FlatIndex on
the same nodes: insert, delete, filter, cosine, all four precisions, state
carried across with load_state, and the shared npz index format in both
directions. f32 tolerance rtol 1e-5, atol 1e-5; ids equal except between
tied values."""

import numpy as np
import pytest
import torch

from tests.torch_parity import assert_topk_parity, recall
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.datasets import embedding_like
from vector_db_tpu.index.flat import FlatIndex as JaxFlat
from vector_db_tpu.storage import InMemoryNodeStorage
from vector_db_tpu.types import Node
from vector_db_tpu_torch.index.flat import FlatIndex
from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PRECISIONS = ["f32", "bf16", "blocksel", "blocksel2p"]


def _nodes(x, start=0):
    return [Node(id=start + i, embedding=x[i]) for i in range(x.shape[0])]


def _corpus(seed=0, nrows=1500, dim=64, b=16):
    x = embedding_like(nrows + b, dim, seed=seed, intrinsic=16,
                       device="numpy")
    return x[:nrows], x[nrows:]


def _pair(x, deleted=(), **kw):
    """(port, JAX) indexes holding the same nodes."""
    port = FlatIndex(device="cpu", **kw)
    ref = JaxFlat(**kw)
    for idx in (port, ref):
        idx.insert_nodes(_nodes(x))
        for i in deleted:
            idx.delete_node(i)
    return port, ref


def _check(port, ref, q, k=10, **kw):
    d_got, i_got = port.search_batch(q, k, **kw)
    d_want, i_want = ref.search_batch(q, k, **kw)
    assert i_got.dtype == np.int64 and d_got.dtype == np.float32
    assert_topk_parity(d_got, i_got, d_want, i_want)
    return i_got


@pytest.mark.parametrize("precision", PRECISIONS)
def test_precisions_match_jax(precision):
    x, q = _corpus()
    port, ref = _pair(x, deleted=range(0, 1500, 7), capacity=2048,
                      precision=precision)
    ids = _check(port, ref, q)
    assert not set(ids.ravel().tolist()) & set(range(0, 1500, 7))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_mirror_recall_against_exact(precision):
    """Every precision is held to the port's own f32 scan; the port's
    recall is at least the JAX index's on the same data."""
    x, q = _corpus(seed=1)
    port, ref = _pair(x, capacity=2048, precision=precision)
    truth, _ = _pair(x, capacity=2048)
    _, exact = truth.search_batch(q, 10)
    _, got = port.search_batch(q, 10)
    _, want = ref.search_batch(q, 10)
    assert recall(got, exact) >= recall(want, exact)


@pytest.mark.parametrize("precision", ["f32", "blocksel2p"])
def test_filter_matches_jax(precision):
    x, q = _corpus(seed=2)
    port, ref = _pair(x, capacity=2048, precision=precision)
    allowed = set(range(100, 1500, 3))
    ids = _check(port, ref, q, filter_ids=allowed)
    assert set(ids[ids >= 0].tolist()) <= allowed


def test_cosine_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((600, 24)) * 5).astype(np.float32)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    port, ref = _pair(x, capacity=1024, metric="cosine")
    _check(port, ref, q, k=8)


def test_growth_and_search_single():
    x, q = _corpus(seed=4, nrows=700)
    port, ref = _pair(x)              # default capacity 256: grows to 1024
    assert port._store.capacity == ref._store.capacity == 1024
    _check(port, ref, q)
    got = port.search(q[0], 5, filter_ids={3, 4, 5})
    want = ref.search(q[0], 5, filter_ids={3, 4, 5})
    assert [nd.id for nd, _ in got] == [nd.id for nd, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                               rtol=1e-5, atol=1e-5)


def test_more_k_than_rows_and_empty():
    x, q = _corpus(seed=5, nrows=6)
    port = FlatIndex(device="cpu")
    d, i = port.search_batch(q, 4)
    assert (i == -1).all() and np.isinf(d).all()
    port.insert_nodes(_nodes(x))
    d, i = port.search_batch(q, 9)
    assert (i[:, 6:] == -1).all() and np.isinf(d[:, 6:]).all()


def test_k_above_kernel_limit_raises():
    """The kernel wrapper keeps its k <= 256 limit on every device; the
    index answers above it (on the CPU the tiled plain scan, on a CUDA
    device passes of the kernel)."""
    x, q = _corpus(seed=6, nrows=300)
    port = FlatIndex(device="cpu")
    port.insert_nodes(_nodes(x))
    with pytest.raises(ValueError, match="256"):
        l2_topk(torch.from_numpy(q), port._store.emb, port._store.valid, 257)
    d, i = port.search_batch(q, 257)
    assert i.shape == (16, 257) and (i[:, :256] >= 0).all()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_k_300_matches_jax(precision):
    """k above the l2_topk kernel's 256 (the JAX FlatIndex answers)."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    port, ref = _pair(x, deleted=range(0, 600, 9), capacity=1024,
                      precision=precision, bf16_guard="off")
    ids = _check(port, ref, q, k=300)
    assert ids.shape == (2, 300) and (ids >= 0).all()


@pytest.mark.parametrize("precision", PRECISIONS)
def test_load_state_from_jax_index(precision):
    x, q = _corpus(seed=7)
    ref = JaxFlat(capacity=2048, precision=precision)
    ref.insert_nodes(_nodes(x))
    for i in range(0, 1500, 5):
        ref.delete_node(i)
    port = FlatIndex(device="cpu", precision=precision, storage=ref.storage)
    port.load_state(np.asarray(ref._store.emb), np.asarray(ref._store.valid),
                    ref._store.export_id_map())
    assert port.size == ref.size
    _check(port, ref, q)
    # the adopted id map keeps recycling freed slots like the JAX store
    port.insert_nodes(_nodes(x[:3], start=5000))
    ref.insert_nodes(_nodes(x[:3], start=5000))
    np.testing.assert_array_equal(port._store.export_id_map(),
                                  ref._store.export_id_map())


def test_load_state_rejects_inconsistent_arrays():
    port = FlatIndex(device="cpu")
    emb = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="valid"):
        port.load_state(emb, np.array([1, 0, 0, 0], bool),
                        np.array([-1, -1, -1, -1]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_index_round_trips_between_packages(tmp_path, writer):
    x, q = _corpus(seed=8, nrows=800)
    storage = InMemoryNodeStorage()
    path = tmp_path / "flat.index.npz"
    make = {"jax": lambda: JaxFlat(storage=storage, index_file=path),
            "port": lambda: FlatIndex(storage=storage, index_file=path,
                                      device="cpu")}
    src = make[writer]()
    src.insert_nodes(_nodes(x))
    src.delete_node(10)
    src.save_index()
    dst = make["port" if writer == "jax" else "jax"]()
    dst.load_index()
    assert dst.size == src.size == 799
    np.testing.assert_array_equal(dst._store.export_id_map()[:799],
                                  src._store.export_id_map()[
                                      src._store.export_id_map() >= 0])
    _check(dst, src, q) if writer == "jax" else _check(src, dst, q)


def _bad_corpus(n=512, dim=64, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, dim)).astype(np.float32) * 256.0
    base = centers[rng.integers(8, size=n)]
    return (base + 0.01 * rng.standard_normal((n, dim))).astype(np.float32)


def test_bf16_guard_refuses_like_jax():
    x = _bad_corpus()
    port, ref = _pair(x, capacity=512, precision="bf16",
                      bf16_guard="refuse")
    for idx in (port, ref):
        with pytest.raises(RuntimeError, match="bf16 scan calibration"):
            idx.search_batch(x[:4], k=5)
    assert port.bf16_calibration < 0.9
    assert port.bf16_calibration >= ref.bf16_calibration


def test_bf16_guard_calibration_matches_jax_on_healthy_corpus():
    x, q = _corpus(seed=9, nrows=600)
    port, ref = _pair(x, capacity=1024, precision="bf16",
                      bf16_guard="refuse")
    _check(port, ref, q)
    assert port.bf16_calibration == pytest.approx(ref.bf16_calibration)
    assert port._calibrated_size == ref._calibrated_size == 600


@pytest.mark.parametrize("precision", ["blocksel", "blocksel2p"])
def test_blocksel_recall_on_sift_like_matches_jax(precision):
    """The block scans' recall depends on the corpus: on SIFT-like rows it
    is below 1.0 in the JAX package too. Both packages run the same rows;
    each is held to its own f32 scan, and the two recalls must agree within
    0.01 (the recall itself is recorded, not asserted)."""
    from vector_db_tpu.datasets import sift_like

    x, q = sift_like(6000, dim=128, seed=0, n_clusters=64, queries=64)
    port, ref = _pair(x, capacity=8192, precision=precision)
    port_f32, ref_f32 = _pair(x, capacity=8192)
    got = recall(port.search_batch(q, 10)[1], port_f32.search_batch(q, 10)[1])
    want = recall(ref.search_batch(q, 10)[1], ref_f32.search_batch(q, 10)[1])
    print(f"{precision} recall@10 on sift_like: port {got:.4f}, "
          f"JAX {want:.4f}")
    assert abs(got - want) <= 0.01
