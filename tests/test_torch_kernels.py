"""The three CUDA kernels' plain versions against the Pallas kernels they
replace (interpret mode on CPU), on the same numpy inputs. The kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py.

f32 tolerance rtol 1e-5, atol 1e-5 (two summation orders; bf16 x bf16
products are exact in f32). Ids are compared wherever values are apart.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import assert_topk_parity, n, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.ops.pallas.block_min import block_min_scan as jax_block_min
from vector_db_tpu.ops.pallas.block_topm import (
    block_topm_scan as jax_block_topm,
)
from vector_db_tpu.ops.pallas.l2_topk import l2_topk as jax_l2_topk
from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan
from vector_db_tpu_torch.ops.cuda.block_topm import block_topm_scan
from vector_db_tpu_torch.ops.cuda.l2_topk import MAX_K, l2_topk

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _corpus(seed, nrows, dim, invalid_every=0, dup_rows=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nrows, dim)).astype(np.float32)
    if dup_rows:
        x[1:dup_rows] = x[0]
    valid = np.ones(nrows, bool)
    if invalid_every:
        valid[::invalid_every] = False
    return rng, x, valid


# -- l2_topk -----------------------------------------------------------------

@pytest.mark.parametrize("nrows,dim,b,k,invalid_every", [
    (500, 64, 8, 10, 7),        # N not a multiple of 128, invalid rows
    (4096, 128, 33, 16, 0),
    (300, 32, 1, 5, 3),         # B = 1
])
def test_l2_topk_plain_matches_pallas(nrows, dim, b, k, invalid_every):
    rng, x, valid = _corpus(0, nrows, dim, invalid_every)
    q = rng.standard_normal((b, dim)).astype(np.float32)
    got = l2_topk(t(q), t(x), t(valid), k, tile=256)
    want = jax_l2_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), k,
                       tile=128, interpret=True)
    assert got[1].dtype == torch.int32
    assert_topk_parity(*got, *want)


def test_l2_topk_more_k_than_valid_rows_pads():
    rng, x, _ = _corpus(1, 200, 16)
    valid = np.zeros(200, bool)
    valid[[5, 77, 150]] = True
    q = rng.standard_normal((3, 16)).astype(np.float32)
    got = l2_topk(t(q), t(x), t(valid), 6, tile=64)
    want = jax_l2_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(valid), 6,
                       tile=128, interpret=True)
    assert_topk_parity(*got, *want)
    assert (n(got[1])[:, 3:] == -1).all()
    assert (n(got[0])[:, 3:] == np.float32(3e38)).all()


def test_l2_topk_duplicate_rows_tie_values():
    rng, x, valid = _corpus(2, 256, 32, dup_rows=12)
    q = (x[:2] + 0.01).astype(np.float32)
    got_d, got_i = l2_topk(t(q), t(x), t(valid), 8)
    d = n(got_d)
    assert set(n(got_i)[0].tolist()) <= set(range(12))
    np.testing.assert_allclose(d[0], d[0, 0], rtol=1e-5)


def test_l2_topk_bf16_table_formula():
    """bf16 table: bf16-cast query, f32 norms supplied, no clamp."""
    rng, x, valid = _corpus(3, 700, 48, invalid_every=5)
    q = rng.standard_normal((9, 48)).astype(np.float32)
    x16 = t(x).to(torch.bfloat16)
    x_sq = (x * x).sum(-1)
    got = l2_topk(t(q), x16, t(valid), 7, x_sq=t(x_sq), tile=128)
    qc = q.astype(jnp.bfloat16).astype(np.float32).astype(np.float64)
    xb = n(x16).astype(np.float64)
    d = (q.astype(np.float64) ** 2).sum(-1)[:, None] - 2 * qc @ xb.T \
        + x_sq[None, :]
    d = np.where(valid[None, :], d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :7]
    assert_topk_parity(got[0], got[1],
                       np.take_along_axis(d, order, 1).astype(np.float32),
                       order.astype(np.int32), atol=1e-4)


@pytest.mark.parametrize("k", [0, MAX_K + 1])
def test_l2_topk_rejects_k_out_of_range(k):
    x = t(np.zeros((4, 8), np.float32))
    with pytest.raises(ValueError, match=str(MAX_K)):
        l2_topk(x, x, t(np.ones(4, bool)), k)


def test_l2_topk_launch_counter_is_cuda_only():
    before = l2_topk.launches
    x = t(np.ones((130, 8), np.float32))
    l2_topk(x[:2], x, t(np.ones(130, bool)), 3)
    assert l2_topk.launches == before


# -- block_topm / block_min --------------------------------------------------

def _mirror(seed, nrows, ds, b, invalid_every=13, dup_rows=0,
            dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((nrows, ds)).astype(np.float32)
    if dup_rows:
        tab[1:dup_rows] = tab[0]
    tab = n(t(tab).to(dtype))  # values representable in the table dtype
    q = rng.standard_normal((b, ds)).astype(np.float32)
    xsq = (rng.random(nrows) * 10).astype(np.float32)
    if dup_rows:
        xsq[1:dup_rows] = xsq[0]
    vm = np.ones(nrows, bool)
    if invalid_every:
        vm[::invalid_every] = False
    xsq_eff = np.where(vm, xsq, np.float32(2e38)).astype(np.float32)
    jtab = jnp.asarray(tab).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return (t(q), t(tab).to(dtype), t(xsq_eff)), (
        jnp.asarray(q), jtab, jnp.asarray(xsq_eff))


@pytest.mark.parametrize("nrows,ds,b,m,dtype", [
    (4096 + 512 - 70, 64, 37, 4, torch.bfloat16),  # ragged last block
    (2048, 128, 8, 2, torch.bfloat16),
    (1000, 96, 1, 3, torch.float32),               # B = 1, f32 table
])
def test_block_topm_plain_matches_pallas(nrows, ds, b, m, dtype):
    port, ref = _mirror(0, nrows, ds, b, dtype=dtype)
    vals, rows = block_topm_scan(*port, m=m)
    jv, jr = jax_block_topm(*ref, block=128, m=m, tile=1024, qtile=64,
                            interpret=True)
    width = math.ceil(nrows / 128) * m
    assert vals.shape == (b, width) and rows.dtype == torch.int32
    # the JAX padding blocks past ceil(N/128) hold only 2e38
    assert (n(jv)[:, width:] >= 2e38).all()
    assert_topk_parity(n(vals).reshape(-1, m), n(rows).reshape(-1, m),
                       n(jv)[:, :width].reshape(-1, m),
                       n(jr)[:, :width].reshape(-1, m))


def test_block_topm_first_match_on_ties():
    """All rows of block 0 are equal: the m winners are its first m rows,
    as the Pallas kernel's first-match argmin gives."""
    port, ref = _mirror(1, 512, 32, 4, invalid_every=0, dup_rows=128)
    vals, rows = block_topm_scan(*port, m=4)
    jv, jr = jax_block_topm(*ref, block=128, m=4, tile=512, qtile=64,
                            interpret=True)
    assert (n(rows)[:, :4] == np.arange(4)).all()
    np.testing.assert_array_equal(n(rows)[:, :4], n(jr)[:, :4])


@pytest.mark.parametrize("nrows,ds,b", [(4096 + 512 - 70, 64, 37),
                                        (2048, 128, 8)])
def test_block_min_plain_matches_pallas(nrows, ds, b):
    port, ref = _mirror(2, nrows, ds, b)
    mins = block_min_scan(*port)
    jm = jax_block_min(*ref, block=128, tile=1024, qtile=64, interpret=True)
    nb = math.ceil(nrows / 128)
    assert mins.shape == (b, nb)
    np.testing.assert_allclose(n(mins), n(jm)[:, :nb], rtol=1e-5, atol=1e-5)


def test_block_min_fully_invalid_block():
    rng = np.random.default_rng(3)
    tab = t(rng.standard_normal((1024, 32)).astype(np.float32)).bfloat16()
    q = t(rng.standard_normal((4, 32)).astype(np.float32))
    xsq = np.where(np.arange(1024) < 128, np.float32(2e38),
                   rng.random(1024).astype(np.float32)).astype(np.float32)
    mins = n(block_min_scan(q, tab, t(xsq)))
    assert (mins[:, 0] > 1e37).all() and (mins[:, 1:] < 1e37).all()


def test_block_scans_reject_other_block_sizes():
    x = t(np.zeros((256, 8), np.float32))
    with pytest.raises(ValueError, match="128"):
        block_topm_scan(x[:1], x, t(np.zeros(256, np.float32)), block=64)
    with pytest.raises(ValueError, match="128"):
        block_min_scan(x[:1], x, t(np.zeros(256, np.float32)), block=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [MAX_K + 1, 600, 1300])   # 1300 > valid rows
def test_l2_topk_floor_passes_join_into_the_top_k(dtype, k):
    """A list past 256 as the card runs it: passes of 256, each from the
    last one's final (value, row) pair (``after``), join into the top-k
    that one plain scan at k gives, pads included. On the CPU each pass is
    the plain version at its floor, the first at one before every row, so
    that each selects in (value, row) order as the kernel does; on the card
    the kernel at its floor is held against that (test_torch_cuda.py)."""
    from vector_db_tpu_torch.ops.cuda import by_passes
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk_plain

    _, x, valid = _corpus(31, 1200, 16, invalid_every=9, dup_rows=5)
    q = np.random.default_rng(32).standard_normal((6, 16)).astype(np.float32)
    tab, x_sq = t(x).to(dtype), t((x * x).sum(-1))
    start = (t(np.full(6, -np.inf, np.float32)), t(np.full(6, -1, np.int32)))
    got = by_passes(lambda after: l2_topk(
        t(q), tab, t(valid), MAX_K, x_sq=x_sq, tile=500,
        after=start if after is None else after), k, MAX_K)
    want = l2_topk_plain(t(q), tab, t(valid), k, x_sq, 500)
    assert_topk_parity(*got, *want, rtol=0, atol=0)
    assert (n(got[1])[:, int(valid.sum()):] == -1).all()


def test_floor_orders_by_value_then_row_with_pads_last():
    """``after`` admits what comes after its pair in (value, row) order:
    a greater value, or the same value at a later row; a pad's row (-1,
    as uint32) comes after every row, so a pad floor admits nothing."""
    from vector_db_tpu_torch.ops.cuda import floor_mask

    vals = t(np.array([[1.0, 2.0, 2.0, 2.0, 3.0],
                       [1.0, 2.0, 2.0, 2.0, 3.0]], np.float32))
    rows = t(np.arange(5, dtype=np.int32))
    after = (t(np.array([2.0, 3.0], np.float32)),
             t(np.array([2, -1], np.int32)))
    np.testing.assert_array_equal(
        n(floor_mask(vals, rows, after)),
        [[False, False, False, True, True], [False] * 5])
