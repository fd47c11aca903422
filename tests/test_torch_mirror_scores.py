"""The mirror_scores wrapper on the CPU: its plain version against the
contract written out in numpy (each product one f32 multiply of the
widened bf16 value, the halving pairs of the row's width, f32 adds), bit
for bit, and against a float64 sum; chunked and whole the same bits; ids
at any row stride; the argument checks. The kernel itself is held to the
plain version on the card in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import vector_db_tpu_torch.ops.cuda.mirror_scores as ms
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu_torch.index.wide_beam import _aug_scores
from vector_db_tpu_torch.ops.cuda.mirror_scores import (
    mirror_scores,
    mirror_scores_plain,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _contract_scores(aug, idx, qa):
    """The scores as the contract states them, in numpy float32: the bf16
    bits widened by a shift, a product each, then at width w the pairs
    s[i] = p[i] + p[i + w // 2], and s[0] += p[w - 1] after them when w is
    odd, down to one value; an id of -1 reads row 0."""
    bits = aug.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32)
    rows = (bits << 16).view(np.float32)[np.maximum(idx.numpy(), 0)]
    p = rows * qa.numpy()[:, None, :]
    while p.shape[-1] > 1:
        w = p.shape[-1]
        h = w // 2
        s = p[..., :h] + p[..., h:2 * h]
        if w % 2:
            s[..., 0] = s[..., 0] + p[..., 2 * h]
        p = s
    return p[..., 0]


def _inputs(seed, nrows, dpa, b, k, bf16_queries):
    rng = np.random.default_rng(seed)
    aug = torch.from_numpy(
        (0.1 * rng.standard_normal((nrows, dpa))).astype(np.float32)).to(
        torch.bfloat16)
    idx = torch.from_numpy(rng.integers(-1, nrows, (b, k)).astype(np.int32))
    qa = torch.from_numpy(rng.standard_normal((b, dpa)).astype(np.float32))
    if bf16_queries:
        qa = qa.to(torch.bfloat16).float()
    return aug, idx, qa


@pytest.mark.parametrize("dpa,b,k,elems,bf16_queries", [
    (128, 16, 224, None, True),      # the wide cell's width
    (128, 4, 300, 128 * 4 * 64, False),   # arbitrary f32 queries, chunked
    (136, 8, 96, None, True),        # dims = 128
    (392, 3, 50, 392 * 3 * 16, True),     # dims = None at d = 384
    (776, 2, 40, None, False),       # dims = None at d = 768
    (129, 5, 33, 1, False),          # odd widths, one candidate a piece
    (9, 6, 20, None, True),
    (1, 2, 7, None, False),
])
def test_cpu_wrapper_equals_the_scoring_chain(monkeypatch, dpa, b, k, elems,
                                              bf16_queries):
    aug, idx, qa = _inputs(dpa, 700, dpa, b, k, bf16_queries)
    whole = mirror_scores_plain(aug, idx, qa)
    if elems is not None:   # the plain version in pieces of the candidates
        monkeypatch.setattr(ms, "SCORE_ELEMS", elems)
    before = mirror_scores.launches
    got = mirror_scores(aug, idx, qa)
    assert mirror_scores.launches == before   # the plain version launches
    np.testing.assert_array_equal(got.numpy(),
                                  _contract_scores(aug, idx, qa))
    assert torch.equal(got, whole)
    assert torch.equal(_aug_scores(aug, idx, qa, chunks=3), whole)
    want = (aug[idx.clamp_min(0).long()].double()
            * qa[:, None, :].double()).sum(-1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_aug_scores_takes_a_broadcast_seed_set():
    """The seed scoring hands ``_aug_scores`` one id row expanded over the
    batch (a view with row stride 0); it scores as the copied ids do."""
    aug, idx, qa = _inputs(3, 500, 128, 6, 64, True)
    seeds = idx[0].clone()
    view = seeds[None, :].expand(6, 64)
    assert not view.is_contiguous()
    assert torch.equal(_aug_scores(aug, view, qa),
                       mirror_scores_plain(aug, view.contiguous(), qa))


def test_ids_at_a_row_stride():
    """Ids whose rows lie apart (a slice of wider ids) score as a copy."""
    aug, idx, qa = _inputs(4, 500, 136, 5, 90, False)
    part = idx[:, 20:70]
    assert not part.is_contiguous()
    assert torch.equal(mirror_scores(aug, part, qa),
                       mirror_scores(aug, part.contiguous(), qa))


def _bad(case):
    aug, idx, qa = _inputs(5, 100, 16, 3, 10, True)
    if case == "aug_dtype":
        aug = aug.float()
    elif case == "idx_dtype":
        idx = idx.long()
    elif case == "qa_dtype":
        qa = qa.double()
    elif case == "qa_rows":
        qa = qa[:2]
    elif case == "qa_width":
        qa = qa[:, :8].contiguous()
    elif case == "idx_dims":
        idx = idx[0]
    elif case == "aug_layout":
        aug = aug.T.contiguous().T
    elif case == "idx_layout":
        idx = idx.T.contiguous().T
    elif case == "qa_layout":
        qa = torch.cat([qa, qa], 1)[:, ::2]
    return aug, idx, qa


@pytest.mark.parametrize("case,match", [
    ("aug_dtype", "aug has dtype"),
    ("idx_dtype", "idx has dtype"),
    ("qa_dtype", "qa has dtype"),
    ("qa_rows", "qa has shape"),
    ("qa_width", "qa has shape"),
    ("idx_dims", "idx has shape"),
    ("aug_layout", "aug is not contiguous"),
    ("idx_layout", "idx is not contiguous"),
    ("qa_layout", "qa is not contiguous"),
])
def test_wrapper_rejects_bad_arguments(case, match):
    with pytest.raises(ValueError, match=match):
        mirror_scores(*_bad(case))
