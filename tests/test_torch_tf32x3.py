"""3xTF32, as the f32 table of the ``l2_topk`` kernel scores, proven on the
CPU: ``split_tf32`` rounds as ``cvt.rna.tf32.f32`` does, and a scan that
sums q_hi.x_hi + q_hi.x_lo + q_lo.x_hi in f32 (three f32 matmuls of the
split parts here, tensor-core products on the card) returns what the JAX
package's exact f32 search returns. Tolerance: chip_smoke's, rtol 1e-5 and
atol 1e-4 scaled by the size of the terms (a near-zero distance is the
difference of terms as large as ||q||^2 + max ||x||^2); ids equal wherever
values are apart; every id within (1 + 1e-5) of the float64 k-th
distance."""

import numpy as np
import pytest
import torch

from vector_db_tpu.ops import exact as jx
from vector_db_tpu_torch.datasets import embedding_like, sift_like
from vector_db_tpu_torch.ops.cuda.l2_topk import split_tf32

RTOL, ATOL = 1e-5, 1e-4


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 in float64: keep 11 significant bits, round half
    away from zero."""
    x64 = x.astype(np.float64)
    m, e = np.frexp(np.abs(x64))  # |x| = m 2^e, m in [0.5, 1)
    return (np.sign(x64) * np.ldexp(np.floor(m * 2048.0 + 0.5) / 2048.0, e)
            ).astype(np.float32)


def _values(seed=0, n=20000):
    """Normal f32 values over many binades, both signs, zeros, and exact
    ties: values whose 13 dropped bits are 0x1000."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))).astype(
        np.float32)
    bits = x.view(np.int32).copy()
    bits[::7] = (bits[::7] & ~0x1FFF) | 0x1000      # ties
    x = bits.view(np.float32)
    x[::101] = 0.0
    x[1::101] = -0.0
    return x


@pytest.mark.parametrize("prop", ["hi_bits", "hi_plus_lo", "rna_reference"])
def test_split_tf32(prop):
    x = _values()
    hi, lo = (a.numpy() for a in split_tf32(torch.from_numpy(x)))
    if prop == "hi_bits":
        # at most 10 explicit mantissa bits, in hi and in lo
        assert not (hi.view(np.int32) & 0x1FFF).any()
        assert not (lo.view(np.int32) & 0x1FFF).any()
    elif prop == "hi_plus_lo":
        err = np.abs(hi.astype(np.float64) + lo - x.astype(np.float64))
        assert (err <= np.exp2(-22) * np.abs(x.astype(np.float64))).all()
    else:
        want_hi = _rna_reference(x)
        np.testing.assert_array_equal(hi, want_hi)
        np.testing.assert_array_equal(
            lo, _rna_reference((x.astype(np.float64) - hi).astype(
                np.float32)))
        # ties round away from zero
        ties = (x.view(np.int32) & 0x1FFF) == 0x1000
        assert (np.abs(hi[ties]) > np.abs(x[ties])).all()


def _emulated_scan(q, x, k):
    """The kernel's f32 formula with 3xTF32 products, on the CPU: three f32
    matmuls of the split parts, q_sq - 2 q.x + x_sq clamped at 0, the k
    smallest by a stable sort (ties to the lower row)."""
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    q_hi, q_lo = split_tf32(qt)
    x_hi, x_lo = split_tf32(xt)
    dot = q_hi @ x_hi.T + q_hi @ x_lo.T + q_lo @ x_hi.T
    d = ((qt * qt).sum(-1)[:, None] - 2.0 * dot
         + (xt * xt).sum(-1)[None, :]).clamp_min(0.0)
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, order).numpy(), order.int().numpy()


def _data(name):
    """Unnormalised corpora with large norms: embedding-like rows scaled and
    shifted off the origin, and SIFT-like rows (norms in the hundreds)."""
    if name == "embedding_like":
        x = embedding_like(4096 + 16, 768, seed=3) * 40.0 + 3.0
        return x[:4096], x[4096:]
    return sift_like(4096, 128, seed=3, queries=16)


@pytest.mark.parametrize("k", [1, 10, 256])
@pytest.mark.parametrize("name", ["embedding_like", "sift_like"])
def test_3xtf32_scan_is_exact(name, k):
    x, q = _data(name)
    got_d, got_i = _emulated_scan(q, x, k)
    want_d, want_i = (np.asarray(a) for a in jx.exact_search(
        q, x, np.ones(x.shape[0], bool), k))
    scale = (q.astype(np.float64) ** 2).sum(1)[:, None] + (
        x.astype(np.float64) ** 2).sum(1).max()
    tol = ATOL + RTOL * (np.abs(want_d) + scale)
    assert (np.abs(got_d - want_d) <= tol).all()
    gap = np.abs(np.diff(want_d.astype(np.float64), axis=1))
    apart = np.ones(want_d.shape, bool)
    apart[:, 1:] &= gap > tol[:, 1:]
    apart[:, :-1] &= gap > tol[:, :-1]
    np.testing.assert_array_equal(got_i[apart], want_i[apart])
    # every id within (1 + 1e-5) of the float64 k-th distance
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    d64 = np.sqrt(np.maximum((q64 * q64).sum(1)[:, None] - 2.0 * q64 @ x64.T
                             + (x64 * x64).sum(1)[None, :], 0.0))
    kth = np.sort(d64, axis=1)[:, k - 1]
    assert (np.take_along_axis(d64, got_i, axis=1)
            <= (1 + 1e-5) * kth[:, None]).all()
