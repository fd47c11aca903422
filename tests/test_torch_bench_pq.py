"""scripts/bench_pq_torch.py against scripts/bench_pq.py on the CPU, at
2,048 SIFT-shaped rows and the script's 1000 queries.

scripts/bench_pq.py fixes N at 1M, so the test composes its JAX calls at
the small N (PQCodec.train, ``_encode_scan``, ``_adc_lut``,
``_adc_search_matmul``, the fetch-4x rerank over ``gather_l2_sq`` and
``masked_top_k_smallest``) on the corpus the port's ``run`` is handed. The
port's codecs adopt the JAX codecs' trained codebooks and rotation
(``PQCodec.train`` patched to take them in order, pq then opq): k-means
draws its initial rows from a ``torch.Generator`` by design, and at 2,048
rows the codebooks' spread would swamp the ADC paths under test.

Held: each codec's ADC recall@100 and fetch-4x rerank recall@100 within
0.02 of JAX's (the PQ rows' tolerance; JAX's one-hot matmul rounds the LUT,
the port's ``adc_topk`` sums in f32), the row names and keys of
BENCH_PQ.json, the one JSON line and the written file, and ``main`` with no
card (exit 1, nothing on stdout, the committed file untouched).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu.datasets import sift_like
from vector_db_tpu.index.pq import PQCodec, _adc_lut, _adc_search_matmul
from vector_db_tpu.index.pq import _encode_scan
from vector_db_tpu.ops.distance import gather_l2_sq
from vector_db_tpu.ops.exact import exact_search_tiled
from vector_db_tpu.ops.topk import masked_top_k_smallest
import vector_db_tpu_torch.index.pq as port_pq

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_common_torch as common  # noqa: E402
import bench_pq_torch as port  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 2048
TOL = 0.02


def _recall(ids, gt):
    return float(np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist()))
                          / port.K for i in range(len(gt))]))


def jax_bench_pq(x, q):
    """scripts/bench_pq.py's calls at len(x) rows: ({codec: recalls},
    {codec: trained JAX codec})."""
    n, dim, k = x.shape[0], port.DIM, port.K
    pad = (-n) % 8192
    corpus_dev = jnp.asarray(np.concatenate(
        [x, np.zeros((pad, dim), np.float32)]))
    qd = jnp.asarray(q)
    valid = jnp.ones((n,), bool)
    gt = np.asarray(exact_search_tiled(qd, corpus_dev[:n], valid, k,
                                       tile=31250)[1])
    rng = np.random.default_rng(0)
    train_rows = x[rng.choice(n, min(port.TRAIN, n), replace=False)]

    @jax.jit
    def rerank(lut_arg, q_arg, codes_arg, corpus_arg, valid_arg):
        _, i4 = _adc_search_matmul(lut_arg, codes_arg, valid_arg, 4 * k,
                                   256, tile=8192)

        def one(qv, ids):
            dv = gather_l2_sq(qv, corpus_arg, ids,
                              jnp.ones_like(ids, dtype=bool))
            return masked_top_k_smallest(dv, ids, k)

        return jax.vmap(one)(q_arg, i4)

    out, codecs = {}, {}
    for label, opq_iters in port.CODECS:
        codec = PQCodec(k=256, chunks=16, dim=dim)
        codec.train(train_rows, seed=0, restarts=2, opq_iters=opq_iters)
        rot = (jnp.asarray(codec.rotation)
               if codec.rotation is not None else None)
        codes = _encode_scan(corpus_dev, codec.codebooks, chunk=8192,
                             rotation=rot)[:n]
        lut = _adc_lut(codec.rotate_queries(np.asarray(qd)),
                       codec.codebooks)
        ids = np.asarray(_adc_search_matmul(lut, codes, valid, k, 256,
                                            tile=8192)[1])
        _, i_r = rerank(lut, qd, codes, corpus_dev[:n], valid)
        out[label] = {"adc_recall_at_100": _recall(ids, gt),
                      "rerank_recall_at_100": _recall(np.asarray(i_r), gt)}
        codecs[label] = codec
    return out, codecs


@pytest.fixture(scope="module")
def both(one_torch_thread, tmp_path_factory):  # noqa: F811
    x, q = sift_like(N, dim=port.DIM, seed=0, queries=port.B)
    want, codecs = jax_bench_pq(x, q)
    order = [codecs[label] for label, _ in port.CODECS]
    out = tmp_path_factory.mktemp("pq") / "out.json"
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        def adopt(self, *a, **kw):
            jc = order.pop(0)
            other = port_pq.PQCodec.from_arrays(
                np.asarray(jc.codebooks), None if jc.rotation is None
                else np.asarray(jc.rotation), device="cpu")
            self.codebooks, self.rotation = other.codebooks, other.rotation
        mp.setattr(port_pq.PQCodec, "train", adopt)
        mp.setattr(port, "card", lambda: "rehearsal card, 700 W")
        mp.setattr(port, "timed", lambda run, q, n_q: (1.0, None))
        with contextlib.redirect_stdout(buf):
            got = port.run(N, "cpu", out, source={"x": x, "q": q})
    lines = buf.getvalue().strip().splitlines()
    return got, want, out, lines


def test_pq_rows_match_jax(both):
    got, want, _, _ = both
    for label, _ in port.CODECS:
        for key in ("adc_recall_at_100", "rerank_recall_at_100"):
            assert abs(got[label][key] - want[label][key]) <= TOL, (
                label, key, got[label][key], want[label][key])
        assert got[label]["train_s"] >= 0 and got[label]["encode_vps"] > 0


def test_pq_rows_named_as_bench_pq_json(both):
    got, _, out, lines = both
    jax_file = json.loads((ROOT / "BENCH_PQ.json").read_text())
    for label, _ in port.CODECS:
        assert set(jax_file[label]) <= set(got[label]), label
    for key in ("N", "dim", "m", "nbits", "k", "compression_x", "data"):
        assert key in got
    assert got["N"] == N and got["card"] == "rehearsal card, 700 W"
    assert [json.loads(line) for line in lines] == [got]
    assert json.loads(out.read_text()) == got


@pytest.mark.parametrize("script,out", [
    ("bench_sift_torch.py", "BENCH_SIFT_TORCH.json"),
    ("bench_pq_torch.py", "BENCH_PQ_TORCH.json"),
    ("bench_1m_torch.py", "BENCH_1M_TORCH.json"),
    ("bench_latency_torch.py", "BENCH_LATENCY_TORCH.json")])
def test_main_without_cuda_exits_1(script, out):
    path = ROOT / out
    before = path.read_bytes() if path.exists() else None
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / script)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 1
    assert res.stdout == ""
    assert "CUDA" in res.stderr
    assert (path.read_bytes() if path.exists() else None) == before


def test_common_timed_and_recall():
    """The shared row timing makes WARM + reps calls on perturbed inputs
    and measures nothing on the CPU; recall counts a row's first k ids."""
    import torch

    seen = []
    qps, dev_ms = common.timed(lambda v: seen.append(float(v[0])) or v,
                               torch.ones(1), 10, reps=2)
    assert len(seen) == common.WARM + 2 and dev_ms is None and qps > 0
    assert seen[-1] == pytest.approx(1.0 + 2e-6)
    assert common.recall_of(np.array([[1, 2, 3]]), np.array([[3, 9]]),
                            2) == 0.0
    assert common.recall_of(np.array([[9, 3, 1]]), np.array([[3, 9]]),
                            2) == 1.0
