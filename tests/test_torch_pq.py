"""The ported PQCodec against vector_db_tpu/index/pq.py on the same numpy
inputs. Codebooks and the OPQ rotation of a trained JAX codec are carried
over with PQCodec.from_arrays, after which both packages compute the same
thing: codes equal, decode / LUT / residual scalars within rtol = atol =
1e-5 (1e-4 with an OPQ rotation, whose f32 matmul rounds in another
order), ADC search tie-aware within 1e-4. The port's own training is held
to the JAX codec's quantization error (within 10 %)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_topk_parity, n, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.index.pq import PQCodec as JaxCodec
from vector_db_tpu.index.pq import (
    ProductQuantizationService as JaxService,
)
from vector_db_tpu.index.pq import (
    _encode_residual_scan as jax_encode_residual_scan,
)
from vector_db_tpu_torch.index.pq import (
    PQCodec,
    ProductQuantizationService,
    _encode_residual_scan,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _correlated(seed, rows=600, dim=32):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((rows, 4)).astype(np.float32)
    mix = rng.standard_normal((4, dim)).astype(np.float32)
    x = (u @ mix + 0.3 * rng.standard_normal((rows, dim))).astype(np.float32)
    return rng, x


def _pair(seed, opq_iters):
    """A trained JAX codec and the port's codec holding its state."""
    rng, x = _correlated(seed)
    ref = JaxCodec(k=16, chunks=8, dim=32)
    ref.train(x, seed=seed, iters=15, restarts=1, opq_iters=opq_iters)
    rot = None if ref.rotation is None else np.asarray(ref.rotation)
    port = PQCodec.from_arrays(np.asarray(ref.codebooks), rot, device="cpu")
    return rng, x, ref, port


@pytest.mark.parametrize("opq_iters", [0, 3])
def test_carried_codec_matches_jax(opq_iters):
    rng, x, ref, port = _pair(1, opq_iters)
    tol = 1e-5 if opq_iters == 0 else 1e-4
    codes = port.encode(x)
    assert codes.dtype == np.int32 and codes.shape == (600, 8)
    np.testing.assert_array_equal(codes, ref.encode(x))
    np.testing.assert_allclose(port.decode(codes), ref.decode(codes),
                               rtol=tol, atol=tol)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    np.testing.assert_allclose(n(port.adc_lut(q)), np.asarray(ref.adc_lut(q)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("opq_iters", [0, 3])
def test_encode_residual_scan_matches_jax(opq_iters):
    rng, x, ref, port = _pair(2, opq_iters)
    cents = rng.standard_normal((6, 32)).astype(np.float32)
    cells = rng.integers(0, 6, 600).astype(np.int32)
    rot = ref.rotation
    cent_rot = cents if rot is None else np.array(
        jnp.dot(jnp.asarray(cents), rot))
    jc, js = jax_encode_residual_scan(
        jnp.asarray(x), jnp.asarray(cells), jnp.asarray(cent_rot),
        ref.codebooks, chunk=200, rotation=rot)
    pc, ps = _encode_residual_scan(t(x), t(cells), t(cent_rot),
                                   port.codebooks, chunk=128,
                                   rotation=port.rotation)
    np.testing.assert_array_equal(n(pc), np.asarray(jc))
    np.testing.assert_allclose(n(ps), np.asarray(js), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["matmul", "pallas", "gather"])
def test_adc_search_modes_match_jax_gather(mode):
    rng, x, ref, port = _pair(3, 0)
    codes = np.array(ref.encode(x))
    codes[1:4] = codes[0]                        # tied distances
    valid = np.ones(600, bool)
    valid[::11] = False
    q = rng.standard_normal((6, 32)).astype(np.float32)
    want = ref.adc_search(q, codes, valid=jnp.asarray(valid), top_k=12,
                          mode="gather")
    got = port.adc_search(q, codes, valid=valid, top_k=12, mode=mode)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert_topk_parity(*got, *want, rtol=1e-4, atol=1e-4)


def test_adc_search_above_kernel_k_matches_gather():
    rng, x, _, port = _pair(4, 0)
    codes = port.encode(x)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    got = port.adc_search(q, codes, top_k=300)
    want = port.adc_search(q, torch.from_numpy(codes).to(torch.uint8),
                           top_k=300, mode="gather")
    assert got[1].shape == (3, 300)
    assert_topk_parity(*got, *want)


BAD_CODECS = [dict(k=0, chunks=2, dim=8), dict(k=2, chunks=0, dim=8),
              dict(k=2, chunks=2, dim=0), dict(k=2, chunks=3, dim=8)]


@pytest.mark.parametrize("kw", BAD_CODECS)
def test_constructor_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxService(**kw)
    with pytest.raises(ValueError, match=str(want.value)):
        ProductQuantizationService(device="cpu", **kw)


@pytest.mark.parametrize("bad", [[[1.0] * 8], np.ones(8, np.float32),
                                 np.ones((4, 6), np.float32),
                                 np.ones((1, 8), np.float32)])
def test_input_errors_match_jax(bad):
    jax_svc = JaxService(k=2, chunks=2, dim=8)
    svc = ProductQuantizationService(k=2, chunks=2, dim=8, device="cpu")
    with pytest.raises((TypeError, ValueError)) as want:
        jax_svc.compress(bad)
    with pytest.raises(want.type, match=str(want.value)):
        svc.compress(bad)
    for codec in (JaxCodec(2, 2, 8), PQCodec(2, 2, 8, device="cpu")):
        with pytest.raises(ValueError, match="trained before encoding"):
            codec.encode(np.ones((3, 8), np.float32))
        with pytest.raises(ValueError, match="trained before decoding"):
            codec.decode(np.zeros((3, 2), np.int32))
        with pytest.raises(ValueError, match="trained before ADC"):
            codec.adc_lut(np.ones((1, 8), np.float32))


@pytest.mark.parametrize("opq_iters", [0, 4])
def test_port_training_matches_jax_quality(opq_iters):
    _, x = _correlated(5, rows=2000)
    errs = {}
    for name, codec in (("jax", JaxCodec(k=16, chunks=8, dim=32)),
                        ("port", PQCodec(k=16, chunks=8, dim=32,
                                         device="cpu"))):
        codec.train(x, seed=0, iters=25, restarts=2, opq_iters=opq_iters)
        errs[name] = float(np.mean((codec.decode(codec.encode(x)) - x) ** 2))
    assert errs["port"] <= 1.1 * errs["jax"], errs


def test_port_opq_rotation_is_orthogonal_and_helps():
    _, x = _correlated(6, rows=2000)
    plain = PQCodec(k=16, chunks=8, dim=32, device="cpu")
    plain.train(x, seed=0, iters=25, restarts=1)
    opq = PQCodec(k=16, chunks=8, dim=32, device="cpu")
    opq.train(x, seed=0, iters=25, restarts=1, opq_iters=6)
    r = n(opq.rotation)
    np.testing.assert_allclose(r @ r.T, np.eye(32), atol=1e-4)
    err_plain = np.mean((plain.decode(plain.encode(x)) - x) ** 2)
    err_opq = np.mean((opq.decode(opq.encode(x)) - x) ** 2)
    assert err_opq < 0.7 * err_plain, (err_opq, err_plain)


def test_compress_shape_range_and_centroids():
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    svc = ProductQuantizationService(k=8, chunks=4, dim=16, device="cpu")
    codes = svc.compress(emb)
    assert codes.shape == (50, 4) and codes.dtype == np.int64
    assert codes.min() >= 0 and codes.max() < 8
    assert len(svc.centroids) == 4 and svc.centroids[0].shape == (8, 4)
    assert (svc.k, svc.chunks, svc.dim, svc.subdim) == (8, 4, 16, 4)
