"""scripts/bench_sift_torch.py against scripts/bench_sift.py on the CPU, at
2,048 SIFT-shaped rows, 32 cells and the script's 1000 queries.

The JAX script runs in a subprocess (JAX_PLATFORMS=cpu, BENCH_N,
BENCH_IVF_K and BENCH_OUT set, the output and the compile cache in a
temporary directory, so nothing in the repo is written), started when the
module begins, through a wrapper that patches its ``timed`` to make no
call (its rows' QPS are not compared; at 1000 queries each Pallas ADC call
runs for seconds in interpret mode) and saves each IVF build's centroids
and each trained PQ codec beside its output. The port's ``run`` gets the
same corpus, ``sift_like(2048, 128, seed=0, queries=1000)``, its ``timed``
patched the same way, and adopts those centroids and codecs in order (its
k-means draws its initial rows from a ``torch.Generator`` by design: on its
own cells, 32 of them over 2,048 rows, the n_probe 8 row reads 0.883
against JAX's 0.9256, a difference of cells, not of search; on JAX's
centroids the inverted lists are JAX's).

Held, row by row by name (every JAX row is in the port's file):
- ``exact_f32``: 1.0 on both sides;
- the scan and block rows (``bf16_scan``, ``blocksel_3p``): within 0.01;
- the IVF and PQ rows (``ivf_rp``, ``ivf_pq_residual``, ``pq_adc_scan``)
  and the probe ceilings: within 0.02.
Also the ``port_adc`` note of each IVF-PQ row and the kept spill-2 index.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import vector_db_tpu_torch.index.ivf as port_ivf
import vector_db_tpu_torch.index.pq as port_pq
from tests.torch_parity import one_torch_thread  # noqa: F401
from vector_db_tpu_torch.datasets import sift_like

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import bench_sift_torch as port  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, CELLS = 2048, 32
SCAN_TOL, IVF_TOL = 0.01, 0.02
JAX_SECONDS = 900
# the JAX script, untimed, leaving its centroids and codecs in its cwd
WRAPPER = """
import os, sys
import numpy as np
sys.path.insert(0, {scripts!r})
import bench_sift as m
from vector_db_tpu.index import ivf, pq

m.timed = lambda run, q, n_q, reps=3: 1.0
made = {{"centroids": 0, "codec": 0}}


def keep(kind, **arrays):
    name = f"{{kind}}_{{made[kind]}}.npz"
    np.savez("part.npz", **arrays)
    os.replace("part.npz", name)
    made[kind] += 1


build, train = ivf.IvfIndex.build_arrays, pq.PQCodec.train


def build_and_keep(self, *a, **kw):
    build(self, *a, **kw)
    keep("centroids", c=np.asarray(self.centroids))


def train_and_keep(self, *a, **kw):
    train(self, *a, **kw)
    rot = {{}} if self.rotation is None else {{"r": np.asarray(self.rotation)}}
    keep("codec", cb=np.asarray(self.codebooks), **rot)


ivf.IvfIndex.build_arrays = build_and_keep
pq.PQCodec.train = train_and_keep
m.main()
"""
WAIT_S = 600


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Start scripts/bench_sift.py at N rows on the CPU; yields
    ``result()``, which waits for it and reads its JSON."""
    cwd = tmp_path_factory.mktemp("jax_sift")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "VDB_FORCE_PLATFORM": "cpu",
           "VDB_TPU_COMPILE_CACHE": str(cwd / "cache"), "BENCH_N": str(N),
           "BENCH_IVF_K": str(CELLS), "BENCH_OUT": str(cwd / "out.json")}
    err = open(cwd / "stderr.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", WRAPPER.format(scripts=str(ROOT / "scripts"))],
        cwd=cwd, env=env, stdout=subprocess.DEVNULL, stderr=err)

    def result():
        rc = proc.wait(timeout=JAX_SECONDS)
        err.close()
        assert rc == 0, Path(err.name).read_text()[-3000:]
        return json.loads((cwd / "out.json").read_text())

    def part(kind, i):
        """The i-th array file of ``kind`` the run leaves, once there."""
        path = cwd / f"{kind}_{i}.npz"
        t0 = time.monotonic()
        while not path.exists():
            assert proc.poll() in (None, 0), Path(err.name).read_text()[-3000:]
            assert time.monotonic() - t0 < WAIT_S, f"no {path.name}"
            time.sleep(0.2)
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    result.part = part
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    err.close()


@pytest.fixture(scope="module")
def port_run(one_torch_thread, jax_run, tmp_path_factory):  # noqa: F811
    x, q = sift_like(N, dim=128, seed=0, queries=port.B)
    out = tmp_path_factory.mktemp("port_sift") / "out.json"
    keep = {}
    buf = io.StringIO()
    made = {"centroids": 0, "codec": 0}

    def next_part(kind):
        made[kind] += 1
        return jax_run.part(kind, made[kind] - 1)

    def jax_centroids(*a, **kw):
        return torch.from_numpy(next_part("centroids")["c"]), None

    def jax_codec(self, *a, **kw):
        z = next_part("codec")
        other = port_pq.PQCodec.from_arrays(z["cb"], z.get("r"),
                                            device="cpu")
        self.codebooks, self.rotation = other.codebooks, other.rotation

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ivf, "kmeans", jax_centroids)
        mp.setattr(port_pq.PQCodec, "train", jax_codec)
        mp.setattr(port, "card", lambda: "rehearsal card, 700 W")
        mp.setattr(port, "timed", lambda run, q, n_q: (1.0, None))
        with contextlib.redirect_stdout(buf):
            got = port.run(N, "cpu", out, source={"x": x, "q": q},
                           k_cells=CELLS, keep=keep)
    return got, keep, out, buf.getvalue().strip().splitlines()


def _tolerance(name):
    if name == "exact_f32":
        return 0.0
    return SCAN_TOL if name in ("bf16_scan", "blocksel_3p") else IVF_TOL


def test_sift_rows_match_jax(port_run, jax_run):
    got, _, _, _ = port_run
    want = jax_run()
    assert want["N"] == got["N"] == N and want["k_cells"] == CELLS
    g, w = chip_smoke.recall_rows(got), chip_smoke.recall_rows(want)
    assert set(w) <= set(g), sorted(set(w) - set(g))
    assert len(w) == 18
    for name, val in w.items():
        assert abs(g[name] - val) <= _tolerance(name), (name, g[name], val)
    assert g["exact_f32"] == w["exact_f32"] == 1.0
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for p, val in want["probe_ceiling"].items():
        assert abs(got["probe_ceiling"][p] - val) <= IVF_TOL, (p, val)


def test_sift_rows_carry_what_they_run(port_run):
    got, keep, out, lines = port_run
    assert [json.loads(line) for line in lines] == [got]
    assert json.loads(out.read_text()) == got
    assert got["card"] == "rehearsal card, 700 W" and got["spill"] == 2
    for row in got["ivf_pq_residual"]:
        want = port.port_adc(row["n_probe"], CELLS, row["adc"])
        assert row["port_adc"] == want
        assert ("plain" in want) == (row["adc"] == "gather"
                                     and row["n_probe"] < CELLS)
    # the kept index: spill 2 with RP, every row in one list or two (a
    # spilled copy past a full list is left out)
    ivf = keep["ivf"]
    assert ivf._spill == 2 and ivf._rp_proj is not None
    count = np.bincount(np.concatenate(ivf.inverted_lists), minlength=N)
    assert count.min() >= 1 and count.max() <= 2
