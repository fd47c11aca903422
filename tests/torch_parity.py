"""Comparison helpers for the parity tests of vector_db_tpu_torch against
vector_db_tpu: the same numpy inputs go through both packages."""

import numpy as np
import pytest
import torch

# f32 values from two summation orders
RTOL = 1e-5
ATOL = 1e-5


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a test module's torch work on one CPU thread. Parallel test
    workers, each with torch's default pool of a thread per core, outnumber
    the cores, and the many small ops of graph searches and service calls
    then wait on each other's threads, tens of times slower than alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def assert_topk_parity(d_got, i_got, d_want, i_want, rtol=RTOL, atol=ATOL,
                       scale=0.0, extra=0):
    """Rows of ascending (values, ids): values agree within the tolerance,
    the -1 pads sit in the same places, and ids are equal wherever a value
    is apart from its neighbours by more than the tolerance (between tied
    values either member may legitimately come first). ``scale`` (scalar or
    one per row) adds rtol * scale to the tolerance: a distance computed as
    q_sq - 2 q.x + x_sq errs relative to its terms, not to itself. With
    ``extra=1`` the want carries one more column than got, the next value,
    so that a near-tie across the last place is not read as a difference."""
    d_got, i_got, d_want, i_want = (n(a) for a in (d_got, i_got, d_want,
                                                   i_want))
    assert d_want.shape[-1] == d_got.shape[-1] + extra
    assert i_want.shape[-1] == i_got.shape[-1] + extra
    after = d_want[..., d_got.shape[-1]:].astype(np.float64)
    d_want = d_want[..., :d_got.shape[-1]]
    i_want = i_want[..., :i_got.shape[-1]]
    assert d_got.shape == d_want.shape and i_got.shape == i_want.shape
    d = d_want.astype(np.float64)
    scale = np.asarray(n(scale), np.float64)
    tol = atol + rtol * (np.abs(d) + (scale[:, None] if scale.ndim else
                                      scale))
    if scale.any():
        bad = np.abs(d_got.astype(np.float64) - d) > tol
        assert not bad.any(), (f"{int(bad.sum())} values differ, max abs "
                               f"err {np.abs(d_got - d)[bad].max()}")
    else:
        np.testing.assert_allclose(d_got, d_want, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(i_got < 0, i_want < 0)
    gap = np.abs(np.diff(d, axis=-1))
    apart = np.ones(d.shape, bool)
    apart[..., 1:] &= gap > tol[..., 1:]
    apart[..., :-1] &= gap > tol[..., :-1]
    if after.shape[-1]:
        apart[..., -1] &= np.abs(after[..., 0] - d[..., -1]) > tol[..., -1]
    np.testing.assert_array_equal(i_got[apart], i_want[apart])


def recall(got_ids, true_ids):
    """Mean recall of id rows against ground-truth id rows (-1 ignored)."""
    got_ids, true_ids = n(got_ids), n(true_ids)
    hits = sum(len(set(g[g >= 0].tolist()) & set(w[w >= 0].tolist()))
               for g, w in zip(got_ids, true_ids))
    return hits / max(1, int((true_ids >= 0).sum()))
