"""A CPU rehearsal of chip_smoke.py's phases 6, 7 and 8 (the port's
services, autotune and the sharded indexes at the config.yaml deployment;
the headline benchmark, bench_torch.run) and of the
new parts of phases 4 and 5 (the IVF
residual projection and full scans; the HNSW PQ / RP traversals, the
PQ-scored wide beam, the inline tables and the pool-free beam) at a tiny
size, so a broken phase shows before a chip call: the phases' sizes cut
down, the card's calls (synchronize, memory stats, its name and SM count,
the profiler, the kernel timer) stubbed, the services' device taken to the
CPU, and the kernel wrappers (which run their plain versions on the CPU
and launch nothing) replaced by ones that count as a launch would.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import vector_db_tpu_torch.embedding.device as emb_device
import vector_db_tpu_torch.index.ivf as port_ivf
import vector_db_tpu_torch.index.wide_beam as wide_beam
import vector_db_tpu_torch.ops.exact as port_exact
import vector_db_tpu_torch.services.indexing_service as isvc
from vector_db_tpu_torch.ops.cuda.adc_probe import adc_probe_scores
from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk
from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk
from vector_db_tpu_torch.ops.cuda.sorted_topk import sorted_topk
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent

SIZES = dict(SVC_N=5100, SVC_DIM=32, SVC_QUERIES=64, SVC_BATCH=100,
             SVC_SINGLE=3, SVC_DELETE=10, SVC_SCAN_THRESHOLD=32,
             SVC_WIDE_B=16, SVC_SINGLE_Q=5, SVC_MIN_SIZE=1024,
             SVC_SMALL_N=2000, SVC_IVF_K=16, SVC_PQ_M=8, HNSW_EFC=64,
             HNSW_M=8, SVC_WIDE_FLOOR=0.9,
             SVC_HTTP={"embed": 2, "batch_docs": 1, "batch_docs_size": 5,
                       "search": 3, "search_batch": 1, "health": 2,
                       "stats": 1},
             AT_SAMPLE=32, AT_BATCHES=(64, 16, 1), AT_SINGLE_Q=5)


def _counting(mp, module, name, wrapper, bf16=False):
    real = getattr(module, name)

    def counted(*args, **kwargs):
        wrapper.launches += 1
        if bf16:
            wrapper.launches_bf16 += int(args[1].dtype == torch.bfloat16)
        return real(*args, **kwargs)
    mp.setattr(module, name, counted)


def test_phase_services_rehearsal(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CPU rehearsal: on a card, chip_smoke.py runs it")
    for name, value in SIZES.items():
        monkeypatch.setattr(chip_smoke, name, value)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "CPU rehearsal")
    monkeypatch.setattr(emb_device, "get_device_info", lambda: {
        "devices": ["cuda:0 CPU rehearsal"]})
    monkeypatch.setattr(chip_smoke, "profile", lambda torch, label, fn: [])
    monkeypatch.setenv("VDB_TPU_WARMUP", "1")   # the phase turns it off
    monkeypatch.setattr(isvc, "config_device",
                        lambda spec: torch.device("cpu"))
    # merge_kernel "auto" is on where the index is on the card
    monkeypatch.setattr(isvc.IndexingService, "_resolve_merge_kernel",
                        lambda self: True)
    _counting(monkeypatch, port_exact, "l2_topk", l2_topk, bf16=True)
    _counting(monkeypatch, wide_beam, "sorted_topk", sorted_topk)
    _counting(monkeypatch, port_ivf, "adc_probe_scores", adc_probe_scores)
    _counting(monkeypatch, port_ivf, "adc_topk", adc_topk)

    kernels = {}
    base = chip_smoke.phase_services(torch, kernels, "card, 700 W")
    out = capsys.readouterr().out
    assert "services summary" in out and "[card, 700 W]" in out
    assert base["index"].size > 0 and len(base["deleted"]) > 0
    bare = [line for line in out.strip().splitlines()
            if not line.endswith("[card, 700 W]")]
    assert not bare, bare
    # each path checks its own counts; the last, phase 7a's IVF-PQ service
    # with autotune, leaves its own
    assert adc_topk.launches > 0 and adc_probe_scores.launches > 0
    # each kernel held against its plain version at the routes' inputs;
    # mirror_scores' record takes the wide route's launches
    assert set(kernels) == {"l2_topk", "l2_topk_bf16", "sorted_topk",
                            "adc_probe", "adc_topk", "mirror_scores"}
    assert set(kernels["mirror_scores"]) == {"launches"}
    for line in ("service scan route: l2_topk torch.bfloat16",
                 "service filtered route: l2_topk torch.bfloat16",
                 "insert scan level 0: l2_topk f32", "flat service: l2_topk",
                 "service wide route B = 1: sorted_topk",
                 "ivf service: adc_probe",
                 "ivf service at n_probe = ivf_k", "ivf rp service",
                 "hnsw rp service", "hnsw pq service", "hnsw beam service",
                 "phase 6 ok", "autotune table b8@0.95:",
                 "autotune table b64@0.95/sel0.1:",
                 "autotune ground truth: l2_topk", "autotuned HNSW service",
                 "autotuned IVF-PQ service", "phase 7a ok"):
        assert line in out, line
    assert np.isfinite(chip_smoke.SCAN_FLOOR)


def _card_stubs(mp):
    """The card's calls the phases make, on the CPU."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        mp.setattr(torch.cuda, name, lambda *a: None)
    mp.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    mp.setattr(torch.cuda, "get_device_properties",
               lambda *a: type("P", (), {"multi_processor_count": 132}))
    mp.setattr(chip_smoke, "profile", lambda torch, label, fn, reps=3: [])
    mp.setattr(chip_smoke, "cuda_ms", lambda torch, fn, reps=5: (fn(), 1.0)[1])
    mp.setattr(chip_smoke, "BOOST_MHZ", 1980.0)


def _kernels():
    return {name: {"launches": 0, "max_abs_err": 0.0} for name in (
        "l2_topk", "l2_topk_bf16", "adc_topk", "adc_probe", "sorted_topk")}


def _batches(queries, seed):
    rng = np.random.default_rng(seed)
    return [queries + 0.01 * rng.standard_normal(queries.shape).astype(
        np.float32) for _ in range(5)]


@pytest.mark.parametrize("route", ["flat", "cell-block scan"])
def test_phase_ivf_rp_and_scans_rehearsal(monkeypatch, capsys, route):
    """Phase 4's new rows on a small sift_like IVF, on each full RP route
    (the residual ratio set after enable_rp picks it): floors lowered to
    what a 64-cell index can give, the biased adc_topk held against its
    plain version, the flat route's l2_topk calls against theirs."""
    if torch.cuda.is_available():
        pytest.skip("a CPU rehearsal: on a card, chip_smoke.py runs it")
    from vector_db_tpu_torch import IvfIndex, datasets

    _card_stubs(monkeypatch)
    for name, value in dict(IVF_CELLS=64, B=32, ADC_CHECK_B=4,
                            RP_FULL_FLOOR=0.8, PQ_SCAN_FLOOR=0.3,
                            RP_CEIL_SLACK=0.2).items():
        monkeypatch.setattr(chip_smoke, name, value)
    _counting(monkeypatch, port_ivf, "adc_topk", adc_topk)
    _counting(monkeypatch, port_exact, "l2_topk", l2_topk, bf16=True)
    real = IvfIndex.enable_rp

    def enable_rp(self, *a, **kw):
        real(self, *a, **kw)
        self._rp_res_ratio = 0.9 if route == "flat" else 0.1

    monkeypatch.setattr(IvfIndex, "enable_rp", enable_rp)
    x, queries = datasets.sift_like(6000, dim=32, seed=0, queries=32)
    ivf = IvfIndex(k=64, device="cpu")
    ivf.build_arrays(range(6000), x, seed=0, iters=8, list_cap_alpha=2.0)
    ivf.enable_pq(chunks=8, ksub=32, opq_iters=1)
    ivf.delete(3)
    _, truth = port_exact.exact_search_tiled(
        torch.from_numpy(queries), ivf._emb, ivf._has_emb, chip_smoke.K)
    kernels = _kernels()
    chip_smoke.ivf_rp_and_scans(torch, kernels, ivf, x, queries,
                                truth.numpy(), _batches(queries, 1), [3])
    out = capsys.readouterr().out
    for line in ("enable_rp(dims=128)", "probe ceilings", "ivf_rp_full:",
                 "ivf_pq_full:", "floors held", f"takes the {route} route",
                 "adc_topk with row and group terms", "IVF RP / full-scan"):
        assert line in out, line
    assert kernels["adc_topk"]["launches"] == 6
    assert kernels["l2_topk_bf16"]["launches"] == (6 if route == "flat"
                                                   else 0)
    assert ("ivf_rp_full flat route: l2_topk" in out) == (route == "flat")


def test_phase_hnsw_modes_rehearsal(monkeypatch, capsys):
    """Phase 5's new rows on a small graph: RP and PQ traversals, the
    PQ-scored wide beam with the sorted_topk merge, the inline tables with
    the pool-free beam and the inline wide beam (floors lowered to a
    3,000-row graph's), and the PQ / RP state through save and reload."""
    if torch.cuda.is_available():
        pytest.skip("a CPU rehearsal: on a card, chip_smoke.py runs it")
    import random

    from vector_db_tpu_torch import HNSW, datasets

    _card_stubs(monkeypatch)
    for name, value in dict(
            B=40, PQ_M=8, PQ_KSUB=32, HNSW_OPQ_ITERS=1, RP_DIMS=16,
            INLINE_DIMS=16, WIDE_SEEDS=256, WIDE_EF=128, WIDE_F=32,
            WIDE_T=6, BEAM_T=8, WIDE_FLOOR=0.5, HNSW_PQ_EF=64,
            HNSW_RP_EFS={64: 0.5}, HNSW_PQ_FLOOR=0.3, WIDE_PQ_FLOOR=0.3,
            WIDE_PQ=dict(ef=128, frontier=32, steps=6, rerank_k=128),
            BEAM_FLOORS={32: 0.3, 48: 0.3}, CLASSIC_EF=64, PERSIST_Q=10,
            HNSW_DIM=32, HNSW_N=3000).items():
        monkeypatch.setattr(chip_smoke, name, value)
    _counting(monkeypatch, wide_beam, "sorted_topk", sorted_topk)
    data = datasets.embedding_like(3040, 32, seed=0)
    x, queries = data[:3000], np.ascontiguousarray(data[3000:])
    idx = HNSW(M=8, ef_construction=64, rng=random.Random(42),
               capacity=4096, l_max=4, device="cpu")
    idx.bulk_build(range(3000), x)
    idx.delete_node(5)
    idx.enable_wide(dims=16, seeds=256)     # the phase's earlier wide rows
    _, truth = port_exact.exact_search_tiled(
        torch.from_numpy(queries), idx._emb, idx._has_emb, chip_smoke.K)
    kernels = _kernels()
    summary = chip_smoke.hnsw_modes(
        torch, kernels, idx, x, queries,
        idx._store.ids_of(truth.numpy()), _batches(queries, 2), [5])
    out = capsys.readouterr().out
    for line in ("enable_rp(dims=16)", "enable_pq(chunks=8", "rp_64:",
                 "pq_64:", "wide_pq:", "inline=True) with its tables",
                 "beam_32:", "beam_48:", "wide_inline:", "floors held"):
        assert line in out, line
    assert kernels["sorted_topk"]["launches"] == 2 * 6 * 6
    assert summary["inline_bytes"] > 0
    monkeypatch.setattr("vector_db_tpu_torch.index.hnsw.resolve_device",
                        lambda spec: torch.device("cpu"))
    chip_smoke.hnsw_persist(torch, idx, x, queries)
    assert "search_batch_pq and search_batch_rp ids" in \
        capsys.readouterr().out


def test_phase_sharding_rehearsal(monkeypatch, capsys):
    """Phase 7b on a small corpus: the sharded flat index against the
    single-device scan and the 2 x 2 mesh, the sharded IVF's merge check,
    the sharded HNSW's build, inserts, deletes and searches beside an
    unsharded HNSW (as phase 6 leaves it), save and reload, the sorted_topk
    check, and the sharded-hnsw service."""
    if torch.cuda.is_available():
        pytest.skip("a CPU rehearsal: on a card, chip_smoke.py runs it")
    import random

    from vector_db_tpu_torch import HNSW, datasets

    _card_stubs(monkeypatch)
    for name, value in dict(SIZES, SH_IVF_CELLS=16, SH_IVF_PROBE=4,
                            SH_CHECK_B=10, SH_SEEDS=64, WIDE_EF=128,
                            WIDE_F=32, WIDE_T=6, SH_CLASSIC_EFS=(50, 64),
                            SH_BEAM=dict(frontier=32, steps=6,
                                         hist=2)).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(isvc, "config_device",
                        lambda spec: torch.device("cpu"))
    _counting(monkeypatch, port_exact, "l2_topk", l2_topk, bf16=True)
    _counting(monkeypatch, wide_beam, "sorted_topk", sorted_topk)
    n, dim = SIZES["SVC_N"], SIZES["SVC_DIM"]
    data = datasets.embedding_like(n + SIZES["SVC_QUERIES"], dim, seed=2)
    x, queries = data[:n], np.ascontiguousarray(data[n:])
    ref = HNSW(M=8, ef_construction=64, rng=random.Random(42),
               capacity=8192, device="cpu")
    ref.bulk_build(range(n), x)
    deleted = {5, 77, 4000}
    for i in deleted:
        ref.delete_node(i)
    ref.enable_wide(dims=16, seeds=256)
    kernels = _kernels()
    out = chip_smoke.phase_sharding(torch, kernels, "card, 700 W", {
        "index": ref, "x": x, "queries": queries, "deleted": deleted})
    text = capsys.readouterr().out
    for line in ("ShardedFlatIndex, 4 shards", "sharded flat: l2_topk",
                 "the 2 x 2 mesh answers the same", "ShardedIVF (16 cells",
                 "ShardedHNSW (4 shards", "ShardedHNSW searches at B = 64",
                 "classic_ef64:", "wide_merge_kernel:", "beam:",
                 "ShardedHNSW save_index", "sharded-hnsw service (2000"):
        assert line in text, line
    assert out["service"]["shards"] == 1
    assert kernels["sorted_topk"]["max_abs_err"] == 0.0


def test_phase_bench_rehearsal(monkeypatch, capsys):
    """Phase 8, the port's headline benchmark run in-process, at a tiny
    size (floors lowered to what 8 queries over 2,048 rows give): its JSON
    line logged, the rows held, the four kernels counted, and the smoke's
    stdout left to the phase's own lines."""
    if torch.cuda.is_available():
        pytest.skip("a CPU rehearsal: on a card, chip_smoke.py runs it")
    import bench_torch
    from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan
    from vector_db_tpu_torch.ops.cuda.block_topm import block_topm_scan

    for name, value in dict(
            BENCH_HNSW_N=1200, BENCH_HEADLINE_N=2048, BENCH_REF_N=1000,
            BENCH_QUERIES=8, BENCH_FLOORS={"bf16_scan": 0.9,
                                           "blocksel_3p": 0.9,
                                           "blocksel_2p": 0.8}).items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(bench_torch, "card", lambda: "card, 700 W")
    _counting(monkeypatch, port_exact, "l2_topk", l2_topk, bf16=True)
    _counting(monkeypatch, port_exact, "block_min_scan", block_min_scan)
    _counting(monkeypatch, port_exact, "block_topm_scan", block_topm_scan)
    kernels = _kernels()
    for name in ("block_min", "block_topm"):
        kernels[name] = {"launches": 0, "max_abs_err": 0.0}

    chip_smoke.phase_bench(torch, kernels, "card, 700 W",
                           torch.device("cpu"))
    out = capsys.readouterr().out
    result = [line for line in out.splitlines()
              if line.startswith("phase 8 bench_torch result")]
    assert len(result) == 1
    line = json.loads(result[0].split("]: ", 1)[1])
    assert "card, 700 W" in line["metric"] and line["value"] > 0
    for part in ("phase 8 rows", "phase 8 host syncs",
                 "phase 8 HNSW detail", "phase 8 ok"):
        assert part in out, part
    assert all(line.startswith("phase 8 ") for line in out.splitlines())
    for name in ("l2_topk", "l2_topk_bf16", "block_min", "block_topm"):
        assert kernels[name]["launches"] > 0, name


def test_phase_10m_rehearsal(monkeypatch, capsys):
    """Phase 9, the 10M x 768 scripts run in-process, at a tiny size
    (10,000 rows over 2,048-row chunks, 40 queries; 8 shards of 512-row
    chunks at blocks_k 4; floors lowered to what that gives): each script's
    line logged, both kernels counted and held, their records filled, and
    the smoke's stdout left to the phase's own lines."""
    if torch.cuda.is_available():
        pytest.skip("a CPU rehearsal: on a card, chip_smoke.py runs it")
    from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan

    one, sh = chip_smoke._scripts()
    for module, values in (
            (chip_smoke, dict(TEN_M_N=10_000, TEN_M_SLICE=16,
                              TEN_M_JAX={8: 0.6, 16: 0.7, 32: 0.8, 64: 0.9},
                              TEN_M_ROUTED_FLOOR=0.8,
                              TEN_M_FILTERED_JAX=0.8,
                              TEN_M_SHARDED_JAX=0.8)),
            (one, dict(CHUNK=2048, B=40, LATENCY_REPS=2)),
            (sh, dict(CHUNK=512, B=8, BLOCKS_K=4))):
        for name, value in values.items():
            monkeypatch.setattr(module, name, value)
    _card_stubs(monkeypatch)
    monkeypatch.setattr(one, "card", lambda: "card, 700 W")
    _counting(monkeypatch, one, "l2_topk", l2_topk, bf16=True)
    _counting(monkeypatch, one, "block_min_scan", block_min_scan)
    kernels = {name: {"launches": 0} for name in ("block_min_10m",
                                                  "l2_topk_10m")}

    chip_smoke.phase_10m(torch, kernels, "card, 700 W", torch.device("cpu"))
    out = capsys.readouterr().out
    for script in ("bench_10m_torch", "dryrun_sharded_10m_torch"):
        result = [line for line in out.splitlines()
                  if line.startswith(f"phase 9 {script} result")]
        assert len(result) == 1, script
        line = json.loads(result[0].split("]: ", 1)[1])
        assert line["N"] == 10_000 and line["card"] == "card, 700 W"
    for part in ("phase 9 one card", "phase 9 block_min bf16 table",
                 "phase 9 l2_topk f32 chunk", "phase 9 block_min f32 table",
                 "phase 9 ok"):
        assert part in out, part
    assert all(line.startswith("phase 9 ") for line in out.splitlines())
    for name in ("block_min_10m", "l2_topk_10m"):
        rec = kernels[name]
        assert rec["launches"] > 0 and rec["max_abs_err"] >= 0, rec
        assert rec["ms"] == rec["plain_ms"] == 1.0
        assert rec["bound_ms"] > 0 and rec["library_ms"] is None
        assert rec["bound_by"] in ("bytes", "operations")


def test_phase_bench_scripts_rehearsal(monkeypatch, capsys):
    """Phase 10, the benchmark scripts of BASELINE configs 3 and 4 run
    in-process, at a tiny size (3,000 rows, 32 cells, 16 queries; the codecs trained for 2
    iterations, the graph searches capped at ef 64, frontier 16 and 4
    steps): each script's line logged, its rows
    matched by name to the committed JAX files (n_probe 4096 read as the
    32 cells, the slack at 1.0: only the lossless rows keep a floor of 1.0),
    the kernels each row must launch counted, the new shapes' records
    filled, and the smoke's stdout left to the phase's own lines."""
    if torch.cuda.is_available():
        pytest.skip("a CPU rehearsal: on a card, chip_smoke.py runs it")
    import vector_db_tpu_torch.index.pq as port_pq
    from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan
    from vector_db_tpu_torch.ops.cuda.block_topm import block_topm_scan

    sift_s, pq_s, m1_s, lat_s = chip_smoke._scripts(chip_smoke.P10_SCRIPTS)
    cells = 32
    for name, value in dict(P10_N=3000, P10_IVF_K=cells, P10_B=16,
                            P10_SLACK=1.0).items():
        monkeypatch.setattr(chip_smoke, name, value)
    for module in (sift_s, pq_s, m1_s, lat_s):
        monkeypatch.setattr(module, "card", lambda: "card, 700 W")
    monkeypatch.setattr(lat_s, "REPS", 1)
    for module in (sift_s, pq_s):
        monkeypatch.setattr(module, "B", 16)
    # the graph searches shallow (the phase's logic is rehearsed, not the
    # searches'): ef 64, frontier 16, 4 steps at most
    from vector_db_tpu_torch.index.hnsw import HNSW
    for name in ("search_batch", "search_batch_wide", "search_batch_beam",
                 "search_batch_rp", "search_batch_pq"):
        real = getattr(HNSW, name)

        def shallow(self, q, k, *a, _real=real, **kw):
            for key, cap in (("ef", 64), ("frontier", 16), ("steps", 4),
                             ("rerank_k", 64)):
                if key in kw:
                    kw[key] = min(kw[key], cap)
            return _real(self, q, k, *a, **kw)
        monkeypatch.setattr(HNSW, name, shallow)
    common = sys.modules["bench_common_torch"]
    monkeypatch.setattr(common, "WARM", 0)
    monkeypatch.setattr(common, "REPS", 1)
    real_train = port_pq.PQCodec.train
    monkeypatch.setattr(
        port_pq.PQCodec, "train",
        lambda self, x, seed=0, iters=100, restarts=4, opq_iters=0,
        opq_sample=65536: real_train(self, x, seed, 2, 1, min(opq_iters, 1),
                                     opq_sample))
    real_jax = chip_smoke._p10_jax

    def jax_at_cells(root):
        text = json.dumps(real_jax(root))
        return json.loads(text.replace('"n_probe": 4096',
                                       f'"n_probe": {cells}'))

    monkeypatch.setattr(chip_smoke, "_p10_jax", jax_at_cells)
    # level 0 of the 3,000-row graph through knn_exact, as at 1M
    monkeypatch.setattr("vector_db_tpu_torch.index.hnsw.BULK_HOST_THRESHOLD",
                        300)
    _card_stubs(monkeypatch)
    _counting(monkeypatch, port_exact, "l2_topk", l2_topk, bf16=True)
    _counting(monkeypatch, port_exact, "block_min_scan", block_min_scan)
    _counting(monkeypatch, port_exact, "block_topm_scan", block_topm_scan)
    _counting(monkeypatch, port_ivf, "adc_probe_scores", adc_probe_scores)
    _counting(monkeypatch, port_ivf, "adc_topk", adc_topk)
    _counting(monkeypatch, port_pq, "adc_topk_long", adc_topk)
    _counting(monkeypatch, pq_s, "adc_topk_long", adc_topk)
    kernels = {name: {"launches": 0, "max_abs_err": 0.0} for name in (
        "l2_topk_p10", "block_min_p10", "adc_topk_p10_k100",
        "adc_topk_p10_k400", "l2_topk_bf16", "block_topm", "adc_probe",
        "adc_topk")}

    chip_smoke.phase_bench_scripts(torch, kernels, "card, 700 W",
                             torch.device("cpu"))
    out = capsys.readouterr().out
    for script in chip_smoke.P10_SCRIPTS:
        result = [line for line in out.splitlines()
                  if line.startswith(f"phase 10 {script} result")]
        assert len(result) == 1, script
        line = json.loads(result[0].split("]: ", 1)[1])
        assert line["card"] == "card, 700 W"
        assert f"phase 10 {script}: " in out
    for part in ("phase 10 l2_topk f32", "phase 10 block_min bf16 SIFT",
                 "phase 10 adc_topk", "phase 10 build_s", "phase 10 ok"):
        assert part in out, part
    assert all(line.startswith("phase 10 ") for line in out.splitlines())
    for name in ("l2_topk_p10", "block_min_p10", "adc_topk_p10_k100",
                 "adc_topk_p10_k400"):
        rec = kernels[name]
        assert rec["launches"] > 0 and rec["max_abs_err"] >= 0, rec
        assert rec["ms"] == rec["plain_ms"] == 1.0
        assert rec["bound_ms"] > 0 and rec["library_ms"] is None
    for name in ("l2_topk_bf16", "block_topm", "adc_probe", "adc_topk"):
        assert kernels[name]["launches"] > 0, name


COUNTING_CHILD = '''
import vector_db_tpu_torch.ops.exact as exact
from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk

_real = exact.l2_topk


def _counted(*args, **kwargs):
    l2_topk.launches += 1
    l2_topk.launches_bf16 += int(args[1].dtype == torch.bfloat16)
    return _real(*args, **kwargs)


import torch  # noqa: E402

exact.l2_topk = _counted
'''


def test_phase_tail_drivers_rehearsal(monkeypatch, capsys, tmp_path):
    """Phase 11, the last four JAX drivers' port scripts, at a tiny size
    (bench_insert over 1,024 rows with batches of 64 and 128; bench_tiered
    at 4,200 rows in batches of 4,100 with 16 queries; bench_sharded at
    32,768 and 4,096 rows; bench_api at 4,096 documents (the wide route's
    least size), 16 queries and 8 single searches, its two services as children whose l2_topk counts as
    a launch through a sitecustomize on their path): each script's line
    logged, its keys matched to the committed JAX files (the insert rows'
    batch sizes read as the small ones), the new shapes' records filled,
    both children ended, and the smoke's stdout left to the phase's own
    lines."""
    if torch.cuda.is_available():
        pytest.skip("a CPU rehearsal: on a card, chip_smoke.py runs it")
    ins, tier, shard, api = chip_smoke._scripts(chip_smoke.P11_SCRIPTS)
    for module, values in (
            (chip_smoke, dict(P11_INSERT_BASE=1024, P11_TIERED_N=4200,
                              P11_SHARDED_N=32_768, P11_SHARDED_HNSW=4096,
                              P11_API_DOCS=4096, P11_API_QUERIES=16,
                              P11_SELF_CHECK=100)),
            (ins, dict(BATCHES=(64, 128))),
            (tier, dict(BATCH=4100, B=16, WARM=0, REPS=1)),
            (shard, dict(STEP=4096))):
        for name, value in values.items():
            monkeypatch.setattr(module, name, value)
    for module in (ins, tier, shard, api):
        monkeypatch.setattr(module, "card", lambda: "card, 700 W")
    real_api, real_ins, real_tier = api.run, ins.run, tier.run
    monkeypatch.setattr(api, "run", lambda *a, **kw: real_api(
        *a, n_single=8, **kw))
    monkeypatch.setattr(ins, "run", lambda *a, **kw: real_ins(
        *a, batches=ins.BATCHES, **kw))
    monkeypatch.setattr(tier, "run", lambda *a, **kw: real_tier(
        *a, batch=tier.BATCH, **kw))
    real_jax = chip_smoke._p11_jax

    def jax_at_batches(root):
        out = real_jax(root)
        text = json.dumps(out["bench_insert_torch"])
        out["bench_insert_torch"] = json.loads(text.replace(
            "_1024_", "_64_").replace("_4096_", "_128_"))
        return out

    monkeypatch.setattr(chip_smoke, "_p11_jax", jax_at_batches)
    (tmp_path / "sitecustomize.py").write_text(COUNTING_CHILD)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), str(ROOT)]))
    _card_stubs(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    _counting(monkeypatch, port_exact, "l2_topk", l2_topk, bf16=True)
    kernels = {name: {"launches": 0, "max_abs_err": 0.0} for name in (
        "l2_topk", "l2_topk_bf16", "l2_topk_p11_b1024", "l2_topk_p11_b4096",
        "l2_topk_p11_shard", "l2_topk_bf16_p11")}
    kernels["l2_topk_p11_b64"] = kernels.pop("l2_topk_p11_b1024")
    kernels["l2_topk_p11_b128"] = kernels.pop("l2_topk_p11_b4096")

    chip_smoke.phase_tail_drivers(torch, kernels, "card, 700 W",
                                  torch.device("cpu"))
    out = capsys.readouterr().out
    for script in chip_smoke.P11_SCRIPTS:
        result = [line for line in out.splitlines()
                  if line.startswith(f"phase 11 {script} result")]
        assert len(result) == 1, script
        assert json.loads(result[0].split("]: ", 1)[1])["card"] == \
            "card, 700 W"
        assert f"phase 11 {script}: every key of the JAX file" in out
    for part in ("phase 11 bench_insert inserted rows",
                 "phase 11 insert scan level 0",
                 "bench_tiered bf16_scan: l2_topk torch.bfloat16",
                 "phase 11 bench_sharded flat shard",
                 "phase 11 bench_api: /health index size 4096",
                 "both children ended", "phase 11 ok"):
        assert part in out, part
    assert all(line.startswith("phase 11 ") for line in out.splitlines())
    for name in ("l2_topk_p11_b64", "l2_topk_p11_b128", "l2_topk_p11_shard",
                 "l2_topk_bf16_p11"):
        rec = kernels[name]
        assert rec["launches"] > 0 and rec["max_abs_err"] >= 0, rec
        assert rec["ms"] == rec["plain_ms"] == 1.0
        assert rec["bound_ms"] > 0 and rec["library_ms"] is None
    assert kernels["l2_topk_p11_shard"]["launches"] == 16
    assert kernels["l2_topk"]["launches"] > 0
    assert kernels["l2_topk_bf16"]["launches"] > 0
