"""The port's host-side serving modules against the contracts of
tests/test_core.py, test_embedding.py, test_native_metadata.py,
test_observability.py and tests/storage/test_engine_and_disk.py, on the
CPU: config (defaults, merge, env var, the cuda default), util, search
bucketing, the fake embedder (the JAX package's bits), the
sentence-transformers wrapper (mocked), the embedding device picker, the
native metadata index (both backends, a reopen), the torch.profiler trace,
MemoryMappingService and DiskNodeStorage.
"""

import random
from unittest.mock import MagicMock, patch

import numpy as np
import pytest
import torch
import yaml

from vector_db_tpu.embedding.fake import HashingEmbedder as JaxHashingEmbedder
from vector_db_tpu.native.metadata import MetadataIndex as JaxMetadataIndex
from vector_db_tpu_torch import config as port_config
from vector_db_tpu_torch.config import Config, load_config
from vector_db_tpu_torch.embedding.device import (
    get_device,
    get_device_info,
    is_accelerator_available,
)
from vector_db_tpu_torch.embedding.fake import HashingEmbedder
from vector_db_tpu_torch.engine import MemoryMappingService
from vector_db_tpu_torch.native.metadata import MetadataIndex
from vector_db_tpu_torch.observability import Timer, annotate, trace
from vector_db_tpu_torch.services.storage_service import StorageService
from vector_db_tpu_torch.storage.disk import DiskNodeStorage
from vector_db_tpu_torch.types import Node
from vector_db_tpu_torch.util import (euclidean_vector_distance,
                                      top_k_indices_sorted)
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---- config, util (test_core.py) ----

def test_euclidean_distance():
    assert euclidean_vector_distance([0, 0], [3, 4]) == pytest.approx(5.0)
    assert euclidean_vector_distance([1, 1], [1, 1]) == 0.0


def test_top_k_indices_sorted():
    v = np.array([1.0, 9.0, 3.0, 7.0])
    np.testing.assert_array_equal(top_k_indices_sorted(v, 2), [1, 3])
    np.testing.assert_array_equal(top_k_indices_sorted(v, 10), [1, 3, 2, 0])


def test_config_defaults():
    cfg = load_config("/nonexistent/path.yaml")
    assert cfg["index"]["M"] == 16
    assert cfg["index"]["ef_construction"] == 200
    assert cfg["index"]["flush_threshold"] == 1000
    assert cfg["vector_db"]["capacity"] == 1_000_000
    assert cfg["embedding"]["dimension"] == 384
    # the port's one difference: the index goes on the card by default
    assert cfg["device"] == "cuda"
    assert Config.load("/nonexistent/path.yaml").embedding.device == "cuda"


def test_config_merge_and_dataclass(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text(yaml.safe_dump({"index": {"M": 4}, "device": "cpu"}))
    cfg = Config.load(p)
    assert cfg.index.M == 4
    assert cfg.index.ef_construction == 200  # default preserved
    assert cfg.vector_db.dimension == 384
    assert cfg.embedding.device == "cpu"


def test_config_env_var(tmp_path, monkeypatch):
    p = tmp_path / "c.yaml"
    p.write_text(yaml.safe_dump({"vector_db": {"capacity": 7}}))
    monkeypatch.setenv("CONFIG_PATH", str(p))
    assert load_config()["vector_db"]["capacity"] == 7
    assert port_config.ENV_CONFIG_PATH == "CONFIG_PATH"
    assert port_config.ENV_USE_EMBEDDING_SERVICE == "USE_EMBEDDING_SERVICE"
    assert port_config.ENV_EMBEDDING_SERVICE_URL == "EMBEDDING_SERVICE_URL"


def test_repo_config_reads_alike_in_both_packages():
    """The root config.yaml (device: tpu) merges to the same dict in both
    packages."""
    from pathlib import Path

    from vector_db_tpu.config import load_config as jax_load

    path = Path(__file__).resolve().parent.parent / "config.yaml"
    assert load_config(path) == jax_load(path)
    assert load_config(path)["device"] == "tpu"


def test_search_bucketing_equivalence(rng):
    """Bucketed shapes return the same results as unbucketed."""
    from vector_db_tpu_torch.index.hnsw import HNSW

    x = rng.standard_normal((120, 16)).astype(np.float32)
    index = HNSW(M=8, ef_construction=40, rng=random.Random(42), capacity=128,
                 device="cpu")
    index.insert_arrays(list(range(120)), x, batch_size=120)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    d1, i1 = index.search_batch(q, k=7, ef=50, bucket=True)
    d2, i2 = index.search_batch(q, k=7, ef=64, bucket=False)
    assert d1.shape == (5, 7)
    # bucketing rounds ef 50->64, so identical search width
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)


# ---- embedding (test_embedding.py) ----

@pytest.mark.parametrize("dim", [16, 32, 384])
def test_hashing_embedder_equals_jax_bit_for_bit(dim):
    texts = ["hello", "", "a dog barked", "ünïcödé ✓", "x" * 500]
    got = HashingEmbedder(dim).embed_texts(texts)
    want = JaxHashingEmbedder(dim).embed_texts(texts)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert HashingEmbedder(dim).model_name == f"fake-{dim}"


def test_hashing_embedder_deterministic():
    e = HashingEmbedder(32)
    a = e.embed_text("hello")
    b = e.embed_text("hello")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (32,)
    assert abs(np.linalg.norm(a) - 1.0) < 1e-5
    assert not np.allclose(a, e.embed_text("other"))
    m = e.embed_texts(["x", "y"])
    np.testing.assert_array_equal(m[1], e.embed_text("y"))
    assert e.embed_texts([]).shape == (0, 32)
    with pytest.raises(ValueError):
        HashingEmbedder(0)


def test_sentence_transformer_wrapper_mocked():
    import vector_db_tpu_torch.embedding.st as st_mod

    fake_model = MagicMock()
    fake_model.get_sentence_embedding_dimension.return_value = 8
    fake_model.encode.return_value = np.ones(8, np.float32)
    fake_cls = MagicMock(return_value=fake_model)
    with patch.object(st_mod, "SentenceTransformer", fake_cls):
        emb = st_mod.SentenceTransformerEmbedder("some-model", device="tpu")
        # the JAX package's accelerator name reads as auto: the card when
        # torch has one, else the CPU
        want = "cuda" if torch.cuda.is_available() else "cpu"
        assert fake_cls.call_args.kwargs["device"] == want
        assert emb.dim == 8
        assert emb.embed_text("hi").shape == (8,)
        fake_model.encode.return_value = np.ones((2, 8), np.float32)
        assert emb.embed_texts(["a", "b"]).shape == (2, 8)
        st_mod.SentenceTransformerEmbedder("m", device="cpu")
        assert fake_cls.call_args.kwargs["device"] == "cpu"
        assert st_mod.has_sentence_transformers()


def test_sentence_transformer_missing_raises(monkeypatch):
    """sentence_transformers is imported when a model is built; a missing
    package raises then, naming it."""
    import builtins

    import vector_db_tpu_torch.embedding.st as st_mod

    real = builtins.__import__

    def no_st(name, *a, **k):
        if name.startswith("sentence_transformers"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(st_mod, "SentenceTransformer", None)
    monkeypatch.setattr(builtins, "__import__", no_st)
    with pytest.raises(RuntimeError, match="sentence-transformers"):
        st_mod.SentenceTransformerEmbedder("some-model")


def test_device_utils_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("the CPU picture of a machine without a card")
    assert get_device("cpu") == "cpu"
    assert get_device("CPU") == "cpu"
    assert get_device("auto") == "cpu"
    assert get_device("cuda") == "cpu"   # the reference picker falls back
    assert is_accelerator_available() is False
    info = get_device_info()
    assert info == {"selected": "cpu", "accelerator_available": False,
                    "device_count": 1, "platforms": ["cpu"],
                    "devices": ["cpu"], "backend": "cpu"}


def test_device_info_names_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    assert get_device("auto") == get_device("tpu") == "cuda"
    info = get_device_info()
    assert info["devices"] == ["cuda:0 NVIDIA H100 80GB HBM3",
                               "cuda:1 NVIDIA H100 80GB HBM3"]
    assert info["device_count"] == 2 and info["backend"] == "cuda"
    assert info["selected"] == "cuda" and info["accelerator_available"]


# ---- native metadata index (test_native_metadata.py) ----

def _populate(idx):
    idx.set(0, {"cat": "a", "n": 1})
    idx.set(1, {"cat": "b", "n": 1})
    idx.set(2, {"cat": "a", "n": 2})
    idx.set(3, {})
    idx.set(4, {"cat": "a", "n": 1, "extra": [1, 2]})


@pytest.mark.parametrize("force_python", [True, False])
def test_metadata_index_queries(force_python):
    idx = MetadataIndex(force_python=force_python)
    assert idx.native is not force_python
    _populate(idx)
    assert idx.size() == 5
    assert idx.query({"cat": "a"}) == {0, 2, 4}
    assert idx.query({"cat": "a", "n": 1}) == {0, 4}
    assert idx.query({"n": 1}) == {0, 1, 4}
    assert idx.query({"cat": "z"}) == set()
    assert idx.query({"extra": [1, 2]}) == {4}
    assert idx.query({}) == {0, 1, 2, 3, 4}
    idx.remove(0)
    assert idx.query({"cat": "a", "n": 1}) == {4}
    idx.set(2, {"cat": "b"})  # re-set replaces old tokens
    assert idx.query({"cat": "a"}) == {4}
    assert idx.query({"cat": "b"}) == {1, 2}


def test_native_library_builds_outside_the_sources():
    from vector_db_tpu_torch import native

    assert MetadataIndex().native
    so = sorted(native.BUILD_DIR.glob("_metadata_index_*.so"))
    assert so and native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert not list(native._SRC.parent.glob("*.so"))


def test_native_and_python_match_jax_fuzz(rng):
    ours = [MetadataIndex(force_python=False), MetadataIndex(force_python=True)]
    ref = JaxMetadataIndex(force_python=True)
    keys = ["a", "b", "c"]
    vals = [1, 2, "x", None, True]
    for i in range(300):
        md = {k: vals[rng.integers(len(vals))]
              for k in keys if rng.random() < 0.6}
        for idx in ours + [ref]:
            idx.set(i, md)
    for i in range(0, 300, 7):
        for idx in ours + [ref]:
            idx.remove(i)
    queries = [{k: v} for k in keys for v in vals] + [{"a": 1, "b": 2}, {}]
    for f in queries:
        want = ref.query(f)
        assert all(idx.query(f) == want for idx in ours), f


def test_storage_service_filter_matches_scan_and_survives_reopen(tmp_path,
                                                                 rng):
    svc = StorageService(str(tmp_path / "vdb"), dim=8, capacity=128)
    for i in range(60):
        svc.save(Node(
            id=i, embedding=rng.standard_normal(8).astype(np.float32),
            metadata={"par": i % 3, "flag": bool(i % 2)},
        ))
    svc.delete(10)
    svc.save(Node(id=11, embedding=np.ones(8, np.float32),
                  metadata={"par": 99}))  # overwrite changes metadata
    filters = [{"par": 0}, {"par": 1, "flag": True}, {"par": 99}, {},
               {"missing": 1}]
    for f in filters:
        assert svc.filter_by_metadata(f) == svc.filter_by_metadata_scan(f), f
    want = {str(f): svc.filter_by_metadata(f) for f in filters}
    svc.close()
    svc2 = StorageService(str(tmp_path / "vdb"), dim=8, capacity=128)
    for f in filters:
        assert svc2.filter_by_metadata(f) == want[str(f)], f
    assert svc2.filter_by_metadata({"par": 99}) == {11}


# ---- observability (test_observability.py) ----

def test_timer_spans():
    t = Timer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    with t.span("b"):
        pass
    snap = t.snapshot()
    assert snap["a"]["count"] == 2 and snap["b"]["count"] == 1
    assert snap["a"]["total_s"] >= 0 and snap["a"]["avg_ms"] >= 0
    t.reset()
    assert t.snapshot() == {}


def test_trace_writes_a_profile_with_the_span(tmp_path):
    with trace(str(tmp_path / "run")):
        with annotate("test-span"):
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    files = list((tmp_path / "run").glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "test-span" in files[0].read_text()


# ---- MemoryMappingService, DiskNodeStorage (test_engine_and_disk.py) ----

@pytest.fixture
def engine_config(tmp_path):
    p = tmp_path / "config.yaml"
    p.write_text(yaml.safe_dump(
        {"index": {"M": 4, "ef_construction": 30, "flush_threshold": 1000},
         "device": "cpu"}))
    return str(p)


def test_engine_validation(tmp_path, engine_config):
    with pytest.raises(ValueError):
        MemoryMappingService(str(tmp_path / "x"), dim=0, capacity=4,
                             config_path=engine_config)
    with pytest.raises(ValueError):
        MemoryMappingService(str(tmp_path / "x"), dim=4, capacity=0,
                             config_path=engine_config)
    with pytest.raises(ValueError):
        MemoryMappingService(str(tmp_path / "x"), dim=4, capacity=4)
    svc = MemoryMappingService(str(tmp_path / "s"), dim=8, capacity=64,
                               config_path=engine_config)
    assert svc.index.device.type == "cpu"
    with pytest.raises(TypeError):
        svc.write([1.0] * 8)
    with pytest.raises(ValueError):
        svc.write(np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError):
        svc.write(np.zeros(4, np.float32))
    with pytest.raises(TypeError):
        svc.read("abc")
    with pytest.raises(IndexError):
        svc.read(999)


def test_engine_round_trip(tmp_path, engine_config, rng):
    """write, read, search, delete, then a fresh engine over the same
    files sees the same data and index."""
    vecs = rng.standard_normal((10, 8)).astype(np.float32)
    svc = MemoryMappingService(str(tmp_path / "p"), dim=8, capacity=32,
                               config_path=engine_config)
    ids = [svc.write(v.astype(np.float64), content=f"c{i}",
                     metadata={"i": i}) for i, v in enumerate(vecs)]
    assert svc.size == 10
    node = svc.read(ids[3])
    assert node.content == "c3" and node.metadata == {"i": 3}
    np.testing.assert_allclose(node.embedding, vecs[3], rtol=1e-5)
    np.testing.assert_allclose(svc.get_embedding(ids[3]), vecs[3])
    res = svc.search(vecs[3], k=1, ef=30)
    assert res[0][0].id == ids[3] and res[0][1] < 1e-3
    svc.delete(ids[9])
    assert svc.size == 9
    with pytest.raises(IndexError):
        svc.read(ids[9])
    svc.index.save_index()
    svc.storage.close()

    svc2 = MemoryMappingService(str(tmp_path / "p"), dim=8, capacity=32,
                                config_path=engine_config)
    assert svc2.size == 9 and svc2.index.size == 9
    assert svc2.search(vecs[2], k=1, ef=30)[0][0].id == ids[2]
    assert all(n.id != ids[9] for n, _ in svc2.search(vecs[9], k=5, ef=30))


def test_disk_storage_crud_and_reopen(tmp_path, rng):
    s = DiskNodeStorage(tmp_path / "db.sqlite", tmp_path / "emb.npy",
                        dim=8, capacity=16)
    v = rng.standard_normal(8).astype(np.float32)
    s.save(Node(id=5, embedding=v, metadata={"a": 1}, content="hello"))
    got = s.get(5)
    assert got.content == "hello" and got.metadata == {"a": 1}
    np.testing.assert_allclose(got.embedding, v, rtol=1e-6)
    np.testing.assert_allclose(s.get_embedding(5), v, rtol=1e-6)
    assert s.size() == 1 and s.get_next_id() == 6
    s.save(Node(id=6, embedding=v, content="kept"))
    s.delete(5)
    assert s.get(5) is None
    s.close()
    s2 = DiskNodeStorage(tmp_path / "db.sqlite", tmp_path / "emb.npy",
                         dim=8, capacity=16)
    assert s2.size() == 1 and s2.get(6).content == "kept"
    with pytest.raises(ValueError):
        s2.save(Node(id=7, embedding=np.zeros(4, np.float32)))
    s2.close()
