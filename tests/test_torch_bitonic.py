"""The port's sorted_topk (its plain version on the CPU) against the JAX
Pallas kernel ``vector_db_tpu/ops/pallas/bitonic_merge.py:sorted_topk`` in
interpret mode, on the shapes of ``tests/ops/test_bitonic_merge.py``.

Keys must be equal exactly. The JAX kernel leaves the order of equal keys
arbitrary, so payloads are compared as a multiset within each run of equal
keys (a run cut by the topk boundary only by its keys). The port's order is
total (key, then column): it equals numpy's stable argsort exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import n, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.ops.pallas.bitonic_merge import sorted_topk as jax_sorted_topk
from vector_db_tpu_torch.index.wide_beam import _aug_scores
from vector_db_tpu_torch.ops.cuda.sorted_topk import (
    sorted_topk,
    sorted_topk_plain,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BIG = np.float32(3.0e38)


def _assert_same_topk(d, od, ov, rd, rv):
    """Keys equal exactly; payload multisets equal per run of equal keys,
    except a run that continues past the cut (its members are a choice)."""
    od, ov, rd, rv = (np.asarray(a) for a in (od, ov, rd, rv))
    np.testing.assert_array_equal(od, rd)
    topk = od.shape[1]
    full = np.sort(np.asarray(d, np.float32), axis=1)
    for row in range(od.shape[0]):
        keys = od[row].astype(np.float32)
        starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
        ends = np.r_[starts[1:], topk]
        for s, e in zip(starts, ends):
            if e == topk and topk < full.shape[1] and full[row, topk] == keys[s]:
                continue
            assert sorted(ov[row, s:e].tolist()) == sorted(rv[row, s:e].tolist())


def _jax(d, v, topk, presorted=0, dtype=jnp.float32):
    return jax_sorted_topk(jnp.asarray(d).astype(dtype), jnp.asarray(v),
                           topk, block_b=d.shape[0], interpret=True,
                           presorted=presorted)


@pytest.mark.parametrize("n_cols,topk", [(64, 16), (100, 32), (4864, 1280)])
def test_plain_matches_jax(rng, n_cols, topk):
    d = rng.standard_normal((8, n_cols)).astype(np.float32)
    v = rng.integers(0, 1 << 20, (8, n_cols)).astype(np.int32)
    od, ov = sorted_topk(t(d), t(v), topk)          # CPU: the plain version
    rd, rv = _jax(d, v, topk)
    _assert_same_topk(d, n(od), n(ov), rd, rv)
    order = np.argsort(d, axis=1, kind="stable")[:, :topk]
    np.testing.assert_array_equal(n(ov), np.take_along_axis(v, order, axis=1))


def test_ties_and_padding_match_jax(rng):
    b, n_cols, topk = 4, 48, 48
    d = np.repeat(rng.standard_normal((b, n_cols // 4)).astype(np.float32),
                  4, axis=1)
    v = np.arange(b * n_cols, dtype=np.int32).reshape(b, n_cols)
    od, ov = sorted_topk(t(d), t(v), topk)
    rd, rv = _jax(d, v, topk)
    _assert_same_topk(d, n(od), n(ov), rd, rv)


@pytest.mark.parametrize("p,k,topk", [(16, 48, 16), (100, 156, 100),
                                      (1280, 3584, 1280)])
def test_presorted_matches_jax(rng, p, k, topk):
    b = 8
    dp = np.sort(rng.standard_normal((b, p)).astype(np.float32), axis=1)
    dk = rng.standard_normal((b, k)).astype(np.float32)
    dp[:, -3:] = BIG
    dk[:, ::7] = BIG
    d = np.concatenate([dp, dk], axis=1)
    v = rng.integers(0, 1 << 20, (b, p + k)).astype(np.int32)
    od, ov = sorted_topk(t(d), t(v), topk, presorted=p)
    rd, rv = _jax(d, v, topk, presorted=p)
    _assert_same_topk(d, n(od), n(ov), rd, rv)


def test_husked_prefix_matches_jax(rng):
    b, p, k, topk = 8, 128, 384, 128
    dp = np.sort(rng.standard_normal((b, p)).astype(np.float32), axis=1)
    husk = rng.random((b, p)) < 0.15
    husk[:, -1] = True
    dp = np.where(husk, BIG, dp)
    d = np.concatenate([dp, rng.standard_normal((b, k)).astype(np.float32)],
                       axis=1)
    v = rng.integers(0, 1 << 20, (b, p + k)).astype(np.int32)
    od, ov = sorted_topk(t(d), t(v), topk)
    rd, rv = _jax(d, v, topk)
    _assert_same_topk(d, n(od), n(ov), rd, rv)


def test_bf16_keys_match_jax(rng):
    b, p, k = 4, 64, 192
    d32 = np.concatenate([np.sort(rng.standard_normal((b, p)), axis=1),
                          rng.standard_normal((b, k))], axis=1)
    d16 = torch.from_numpy(d32.astype(np.float32)).to(torch.bfloat16)
    v = rng.integers(0, 1 << 20, (b, p + k)).astype(np.int32)
    od, ov = sorted_topk(d16, t(v), p, presorted=p)
    assert od.dtype == torch.bfloat16
    rd, rv = _jax(n(d16), v, p, presorted=p, dtype=jnp.bfloat16)
    _assert_same_topk(n(d16), n(od), n(ov), np.asarray(rd, np.float32), rv)


@pytest.mark.parametrize("b,n_cols,topk", [(4, 15616, 1280), (2, 12288, 3000)])
def test_blocked_shapes_match_jax(b, n_cols, topk):
    rng = np.random.default_rng(9)
    d = rng.standard_normal((b, n_cols)).astype(np.float32)
    v = np.arange(b * n_cols, dtype=np.int32).reshape(b, n_cols)
    od, ov = sorted_topk(t(d), t(v), topk)
    rd, rv = _jax(d, v, topk)
    _assert_same_topk(d, n(od), n(ov), rd, rv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_stable_sort(rng, dtype):
    # the order the kernel is held to on the card, and the wide-beam merge
    # without the kernel: ties by column, -0.0 equal to +0.0
    d = torch.from_numpy((rng.standard_normal((6, 900)) * 3).round()
                         .astype(np.float32)).to(dtype)
    d[:, ::5] = -0.0
    d[:, ::11] = float(BIG)
    v = t(rng.integers(0, 1 << 20, (6, 900)).astype(np.int32))
    sk, sv = sorted_topk_plain(d, v, 300)
    order = np.argsort(n(d), axis=1, kind="stable")[:, :300]
    np.testing.assert_array_equal(n(sk), np.take_along_axis(n(d), order, 1))
    np.testing.assert_array_equal(n(sv), np.take_along_axis(n(v), order, 1))


def test_wrapper_rejects_bad_arguments():
    d = torch.zeros((2, 10))
    v = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="topk"):
        sorted_topk(d, v, 11)
    with pytest.raises(ValueError, match="shape"):
        sorted_topk(d, v[:, :5], 3)
    with pytest.raises(ValueError, match="presorted"):
        sorted_topk(d, v, 3, presorted=-1)


def test_mirror_scores_are_bitwise_shape_independent(rng):
    # the wide-beam window dedup needs one row scored in different shapes
    # (seed set, frontier widths, score chunks) to give the same bits
    aug = torch.from_numpy(rng.standard_normal((500, 136)).astype(
        np.float32)).to(torch.bfloat16)
    qa = torch.from_numpy(rng.standard_normal((8, 136)).astype(np.float32))
    idx = t(rng.integers(0, 500, (8, 96)).astype(np.int32))
    whole = _aug_scores(aug, idx, qa)
    chunked = _aug_scores(aug, idx, qa, chunks=5)
    single = torch.cat([_aug_scores(aug, idx[:, j:j + 1], qa)
                        for j in range(idx.shape[1])], 1)
    assert torch.equal(whole, chunked) and torch.equal(whole, single)
    want = (aug[idx.long()].double() * qa[:, None, :].double()).sum(-1)
    np.testing.assert_allclose(n(whole), want.numpy(), rtol=1e-5, atol=1e-4)
