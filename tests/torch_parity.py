"""Comparison helpers for the parity tests of vector_db_tpu_torch against
vector_db_tpu: the same numpy inputs go through both packages."""

import numpy as np
import torch

# f32 values from two summation orders
RTOL = 1e-5
ATOL = 1e-5


def t(a, dtype=None):
    """numpy -> CPU torch tensor."""
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x if dtype is None else x.to(dtype)


def n(a):
    """torch or jax array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy() if a.is_floating_point() \
            else a.detach().cpu().numpy()
    return np.asarray(a)


def assert_topk_parity(d_got, i_got, d_want, i_want, rtol=RTOL, atol=ATOL):
    """Rows of ascending (values, ids): values agree within the tolerance,
    the -1 pads sit in the same places, and ids are equal wherever a value
    is apart from its neighbours by more than the tolerance (between tied
    values either member may legitimately come first)."""
    d_got, i_got, d_want, i_want = (n(a) for a in (d_got, i_got, d_want,
                                                   i_want))
    assert d_got.shape == d_want.shape and i_got.shape == i_want.shape
    np.testing.assert_allclose(d_got, d_want, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(i_got < 0, i_want < 0)
    d = d_want.astype(np.float64)
    tol = atol + rtol * np.abs(d)
    gap = np.abs(np.diff(d, axis=-1))
    apart = np.ones(d.shape, bool)
    apart[..., 1:] &= gap > tol[..., 1:]
    apart[..., :-1] &= gap > tol[..., :-1]
    np.testing.assert_array_equal(i_got[apart], i_want[apart])


def recall(got_ids, true_ids):
    """Mean recall of id rows against ground-truth id rows (-1 ignored)."""
    got_ids, true_ids = n(got_ids), n(true_ids)
    hits = sum(len(set(g[g >= 0].tolist()) & set(w[w >= 0].tolist()))
               for g, w in zip(got_ids, true_ids))
    return hits / max(1, int((true_ids >= 0).sum()))
