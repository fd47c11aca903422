"""The plain reference against a float64 NumPy brute force, at small
sizes, with and without an allow-list, and its bfloat16 control."""

import numpy as np
import pytest
import torch

from benchmark.reference import exact


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def brute(x, q, k, allow=None):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    rows = np.arange(len(x)) if allow is None else np.sort(allow)
    d = np.linalg.norm(q64[:, None, :] - x64[rows][None], axis=2)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, 1), rows[order]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("dim", [16, 96])
def test_topk_matches_float64(filtered, dim, monkeypatch):
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((3000, dim)).astype(np.float32)
    q = rng.standard_normal((37, dim)).astype(np.float32)
    allow = rng.choice(3000, 400, replace=False) if filtered else None
    # small blocks: several query blocks and corpus tiles are merged
    monkeypatch.setattr(exact, "BLOCK_BYTES", 4 * 10 * 700)
    d, i = exact.topk(torch.from_numpy(x), torch.from_numpy(q), 10,
                      allow=None if allow is None else torch.from_numpy(allow))
    want_d, want_i = brute(x, q, 10, allow)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-5, atol=1e-5)


def test_pair_distances_are_float64():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 24)).astype(np.float32)
    q = rng.standard_normal((9, 24)).astype(np.float32)
    rows = rng.integers(0, 500, (9, 7))
    got = exact.pair_distances(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(rows)).numpy()
    want = np.linalg.norm(q.astype(np.float64)[:, None]
                          - x.astype(np.float64)[rows], axis=2)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_bf16_control_distances_are_off():
    """The control's distances carry bfloat16 rounding: at least 1e-4 off
    the float64 distances somewhere, where float32 stays within 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2000, 64)).astype(np.float32)
    q = rng.standard_normal((50, 64)).astype(np.float32)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    gaps = {}
    for dtype in (torch.float32, torch.bfloat16):
        d, i = exact.topk(xt, qt, 10, dtype=dtype)
        ref = exact.pair_distances(xt, qt, i).numpy()
        gaps[dtype] = np.max(np.abs(d.numpy() - ref) / ref)
    assert gaps[torch.float32] < 1e-5
    assert gaps[torch.bfloat16] > 1e-4
