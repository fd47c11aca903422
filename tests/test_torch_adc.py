"""The two ADC kernels' plain versions (what their wrappers run on CPU
tensors) against the Pallas kernels they replace, run in interpret mode,
and against a float64 numpy oracle, on the same numpy inputs. The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py.

Tolerances: against JAX rtol = atol = 2e-4, the JAX kernel test's own (its
hi/lo bf16 LUT pair errs up to ~2^-16 per term; the port sums in f32);
against the float64 oracle rtol = atol = 1e-5 (f32 summation order). Ids
are compared wherever values are apart (duplicate code rows tie exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_topk_parity, n, t
from vector_db_tpu.ops.pallas.adc_probe import (
    adc_probe_scores as jax_adc_probe,
)
from vector_db_tpu.ops.pallas.adc_scan import adc_topk as jax_adc_topk
from vector_db_tpu_torch.ops.cuda.adc_probe import (
    adc_probe_plain,
    adc_probe_scores,
)
from vector_db_tpu_torch.ops.cuda.adc_scan import (
    MAX_K,
    adc_topk,
    adc_topk_plain,
)
from vector_db_tpu_torch.ops.distance import BIG


def _lut(rng, b, m, ksub):
    return (rng.standard_normal((b, m, ksub)) ** 2).astype(np.float32)


def _probe_oracle(lut, codes, corr, valid):
    """float64: sum_j lut[b, j, codes[b, p, j]] + corr, BIG where invalid."""
    b, m, _ = lut.shape
    g = lut.astype(np.float64)[np.arange(b)[:, None, None],
                               np.arange(m)[None, None, :], codes]
    return np.where(valid, g.sum(-1) + corr, BIG)


@pytest.mark.parametrize("m,ksub,p", [(4, 16, 70), (16, 256, 1003),
                                      (8, 256, 33)])
def test_adc_probe_plain_matches_pallas_and_oracle(m, ksub, p):
    rng = np.random.default_rng(m * 1000 + p)
    b = 3
    lut = _lut(rng, b, m, ksub)
    codes = rng.integers(0, ksub, (b, p, m)).astype(np.uint8)
    codes[:, 1] = codes[:, 0]                   # duplicate candidates
    corr = rng.standard_normal((b, p)).astype(np.float32)
    valid = rng.random((b, p)) > 0.2
    got = adc_probe_scores(t(lut), t(codes), t(corr), t(valid))
    assert got.dtype == torch.float32 and got.shape == (b, p)
    np.testing.assert_array_equal(n(got), n(adc_probe_plain(
        t(lut), t(codes), t(corr), t(valid))))
    want = _probe_oracle(lut, codes, corr, valid)
    np.testing.assert_allclose(n(got), want, rtol=1e-5, atol=1e-5)
    # the JAX kernel takes the transposed, widened codes [B, m, P]
    codes_t = np.ascontiguousarray(codes.transpose(0, 2, 1)).astype(np.int32)
    ref = np.asarray(jax_adc_probe(jnp.asarray(lut), jnp.asarray(codes_t),
                                   jnp.asarray(corr), jnp.asarray(valid),
                                   tile=128, interpret=True))
    np.testing.assert_allclose(n(got)[valid], ref[valid], rtol=2e-4,
                               atol=2e-4)
    assert (n(got)[~valid] >= BIG).all() and (ref[~valid] >= BIG).all()


def _scan_inputs(seed, nrows, m, ksub, b, dups=6):
    rng = np.random.default_rng(seed)
    lut = _lut(rng, b, m, ksub)
    codes = rng.integers(0, ksub, (nrows, m)).astype(np.int32)
    codes[1:dups] = codes[0]                    # tied distances
    valid = rng.random(nrows) > 0.1
    return lut, codes, valid


def _scan_oracle(lut, codes, valid, k):
    """float64 distances [B, N] and the rows' ascending order."""
    b, m, _ = lut.shape
    d = lut.astype(np.float64)[:, np.arange(m)[None, :], codes].sum(-1)
    return np.where(valid[None, :], d, np.inf)


@pytest.mark.parametrize("nrows,m,ksub,b,k", [(700, 8, 16, 4, 10),
                                              (1030, 16, 256, 2, 33)])
def test_adc_topk_plain_matches_pallas(nrows, m, ksub, b, k):
    lut, codes, valid = _scan_inputs(nrows, nrows, m, ksub, b)
    got = adc_topk(t(lut), t(codes), t(valid), k)
    assert got[1].dtype == torch.int32
    want = jax_adc_topk(jnp.asarray(lut), jnp.asarray(codes),
                        jnp.asarray(valid), k, tile=128, interpret=True)
    assert_topk_parity(*got, *want, rtol=2e-4, atol=2e-4)
    # and the exact float64 ranking
    d64 = _scan_oracle(lut, codes, valid, k)
    kth = np.sort(d64, axis=1)[:, k - 1]
    picked = np.take_along_axis(d64, n(got[1]).astype(np.int64), axis=1)
    assert (picked <= kth[:, None] * (1 + 1e-5) + 1e-5).all()
    np.testing.assert_allclose(n(got[0]), np.sort(d64, axis=1)[:, :k],
                               rtol=1e-5, atol=1e-5)


def test_adc_topk_more_k_than_valid_rows_pads():
    lut, codes, _ = _scan_inputs(3, 300, 4, 16, 3)
    valid = np.zeros(300, bool)
    valid[[4, 150, 299]] = True
    got = adc_topk(t(lut), t(codes), t(valid), 8)
    want = jax_adc_topk(jnp.asarray(lut), jnp.asarray(codes),
                        jnp.asarray(valid), 8, tile=128, interpret=True)
    assert_topk_parity(*got, *want, rtol=2e-4, atol=2e-4)
    assert (n(got[1])[:, 3:] == -1).all() and (n(got[0])[:, 3:] >= BIG).all()
    assert set(n(got[1])[:, :3].ravel().tolist()) == {4, 150, 299}


def test_adc_topk_uint8_codes_match_int32():
    lut, codes, valid = _scan_inputs(4, 900, 16, 256, 5)
    a = adc_topk(t(lut), t(codes), t(valid), 20)
    b = adc_topk(t(lut), t(codes.astype(np.uint8)), t(valid), 20)
    assert_topk_parity(*a, *b, rtol=0, atol=0)


def test_adc_topk_limits_k_and_plain_takes_any_k():
    lut, codes, valid = _scan_inputs(5, 600, 4, 16, 2)
    with pytest.raises(ValueError, match=str(MAX_K)):
        adc_topk(t(lut), t(codes), t(valid), MAX_K + 1)
    d, i = adc_topk_plain(t(lut), t(codes), t(valid), 300, tile=128)
    d64 = _scan_oracle(lut, codes, valid, 300)
    np.testing.assert_allclose(n(d), np.sort(d64, axis=1)[:, :300],
                               rtol=1e-5, atol=1e-5)
    picked = np.take_along_axis(d64, n(i).astype(np.int64), axis=1)
    np.testing.assert_allclose(picked, n(d), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ksub", [16, 256])
def test_out_of_range_codes_clamp_like_the_uint8_table(ksub):
    """int32 codes below 0 or at/above ksub read the entry of the nearest
    code in [0, ksub) (a JAX gather clamps its index): the same result as
    the clamped uint8 table, in adc_topk_plain, PQCodec.adc_search and
    adc_probe_plain; never a wrap into a neighbouring subspace."""
    from vector_db_tpu_torch.index.pq import PQCodec

    rng = np.random.default_rng(ksub)
    codec = PQCodec(k=ksub, chunks=4, dim=16, device="cpu")
    codec.train(rng.standard_normal((400, 16)).astype(np.float32), iters=5,
                restarts=1)
    codes = rng.integers(-300, ksub + 300, (500, 4)).astype(np.int32)
    clamped = np.clip(codes, 0, ksub - 1).astype(np.uint8)
    valid = rng.random(500) > 0.1
    q = rng.standard_normal((3, 16)).astype(np.float32)
    lut = codec.adc_lut(q)
    got = adc_topk_plain(lut, t(codes), t(valid), 20)
    want = adc_topk_plain(lut, t(clamped), t(valid), 20)
    assert_topk_parity(*got, *want, rtol=0, atol=0)
    for mode in ("matmul", "gather"):
        assert_topk_parity(*codec.adc_search(q, codes, valid, 20, mode=mode),
                           *codec.adc_search(q, clamped, valid, 20,
                                             mode=mode), rtol=0, atol=0)
    # the same LUT entries as the oracle over the clamped codes
    d64 = _scan_oracle(n(lut), clamped.astype(np.int64), valid, 20)
    np.testing.assert_allclose(n(got[0]), np.sort(d64, axis=1)[:, :20],
                               rtol=1e-5, atol=1e-5)
    wide = rng.integers(0, 256, (3, 50, 4)).astype(np.uint8)
    corr = np.zeros((3, 50), np.float32)
    ok = np.ones((3, 50), bool)
    np.testing.assert_array_equal(
        n(adc_probe_plain(lut, t(wide), t(corr), t(ok))),
        n(adc_probe_plain(lut, t(np.minimum(wide, ksub - 1)), t(corr),
                          t(ok))))


def _bias_case(seed, b, cells, width, m, ksub):
    """The full-scan IVF-PQ's inputs, cell-blocked: codes of `cells`
    padded cells of `width` slots, a live prefix of each, a per-row scalar
    and a per-(query, cell) term."""
    rng = np.random.default_rng(seed)
    lut = _lut(rng, b, m, ksub)
    codes = rng.integers(0, ksub, (cells * width, m)).astype(np.uint8)
    live = rng.integers(0, width + 1, (cells, 1))
    valid = (np.arange(width)[None] < live).reshape(-1)
    row = rng.standard_normal(cells * width).astype(np.float32)
    grp = (3.0 * rng.standard_normal((b, cells))).astype(np.float32)
    return lut, codes, valid, row, grp


@pytest.mark.parametrize("terms", ["both", "row", "group"])
def test_adc_topk_plain_biases_match_float64(terms):
    """A row's value is the LUT sum + row_bias[n] + group_bias[b, n //
    group]; the plain version against a float64 oracle (rtol = atol =
    1e-5), the wrapper on CPU tensors taking it."""
    lut, codes, valid, row, grp = _bias_case(1, 4, 13, 37, 8, 64)
    rb = t(row) if terms != "group" else None
    gb = t(grp) if terms != "row" else None
    got = adc_topk(t(lut), t(codes), t(valid), 40, row_bias=rb,
                   group_bias=gb, group=37)
    d64 = _scan_oracle(lut, codes.astype(np.int64), valid, 40)
    if rb is not None:
        d64 = d64 + row.astype(np.float64)[None]
    if gb is not None:
        d64 = d64 + np.repeat(grp.astype(np.float64), 37, axis=1)
    np.testing.assert_allclose(n(got[0]), np.sort(d64, axis=1)[:, :40],
                               rtol=1e-5, atol=1e-5)
    picked = np.take_along_axis(d64, n(got[1]).astype(np.int64), axis=1)
    np.testing.assert_allclose(picked, n(got[0]), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="group_bias"):
        adc_topk(t(lut), t(codes), t(valid), 5, group_bias=t(grp), group=36)


@pytest.mark.parametrize("residual", [True, False])
def test_adc_topk_plain_biases_match_jax_pq_scan(residual):
    """adc_topk_plain with the row and group terms, fed what the port's
    full-scan IVF-PQ feeds it, against the JAX package's
    ``_ivf_pq_scan_cells(rerank=False)`` (its one-hot hi/lo bf16 LUT
    contraction) on the same cell blocks: values within 2^-16 of the LUT
    sum's size (plus 1e-4), ids equal where values are apart."""
    from vector_db_tpu.index.ivf import _ivf_pq_scan_cells
    from vector_db_tpu.index.pq import _adc_lut as jax_lut

    rng = np.random.default_rng(2)
    k_cells, width, m, ksub, sub, b = 8, 29, 4, 32, 6, 5
    dim = m * sub
    cents = rng.standard_normal((k_cells, dim)).astype(np.float32)
    cb = rng.standard_normal((m, ksub, sub)).astype(np.float32)
    cap = k_cells * width
    slots = np.arange(cap, dtype=np.int32).reshape(k_cells, width)
    slots[:, 20:] = -1
    codes = rng.integers(0, ksub, (k_cells, width, m)).astype(np.uint8)
    cell_s = rng.standard_normal((k_cells, width)).astype(np.float32)
    emb = rng.standard_normal((cap, dim)).astype(np.float32)
    has = rng.random(cap) > 0.1
    q = rng.standard_normal((b, dim)).astype(np.float32)
    want = _ivf_pq_scan_cells(
        jnp.asarray(cents), jnp.asarray(slots), jnp.asarray(codes),
        jnp.asarray(cell_s), jnp.asarray(cb), jnp.asarray(emb),
        jnp.asarray(has), jnp.asarray(q), jnp.asarray(q), top_k=31,
        fetch=31, rerank=False, residual=residual, dedup=False, ctile=2,
        qblock=8)
    lut = np.asarray(jax_lut(jnp.asarray(q), jnp.asarray(cb)))
    flat = slots.reshape(-1)
    valid = (flat >= 0) & has[np.maximum(flat, 0)]
    corr = None
    if residual:
        cd = ((q[:, None] - cents[None]) ** 2).sum(-1)
        corr = t((cd - (q * q).sum(-1)[:, None]).astype(np.float32))
    d, pos = adc_topk_plain(t(lut), t(codes.reshape(-1, m)), t(valid), 30,
                            row_bias=t(cell_s.reshape(-1)),
                            group_bias=corr, group=width)
    ids = np.where(n(pos) >= 0, flat[np.maximum(n(pos), 0)], -1)
    size = np.abs(np.asarray(want[0])).max()
    assert_topk_parity(n(d), ids, want[0], want[1], rtol=2.0 ** -16,
                       atol=1e-4, scale=size, extra=1)
