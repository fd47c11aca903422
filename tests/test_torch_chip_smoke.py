"""A CPU rehearsal of chip_smoke.py's phases 6 and 7 (the port's services,
autotune and the sharded indexes at the config.yaml deployment) and of the
new parts of phases 4 and 5 (the IVF
residual projection and full scans; the HNSW PQ / RP traversals, the
PQ-scored wide beam, the inline tables and the pool-free beam) at a tiny
size, so a broken phase shows before a chip call: the phases' sizes cut
down, the card's calls (synchronize, memory stats, its name and SM count,
the profiler, the kernel timer) stubbed, the services' device taken to the
CPU, and the kernel wrappers (which run their plain versions on the CPU
and launch nothing) replaced by ones that count as a launch would.
"""

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

SIZES = dict(SVC_N=5100, SVC_DIM=32, SVC_QUERIES=64, SVC_BATCH=100,
             SVC_SINGLE=3, SVC_DELETE=10, SVC_SCAN_THRESHOLD=32,
             SVC_WIDE_B=16, SVC_SINGLE_Q=5, SVC_MIN_SIZE=1024,
             SVC_SMALL_N=2000, SVC_IVF_K=16, SVC_PQ_M=8, HNSW_EFC=64,
             HNSW_M=8, SVC_WIDE_FLOOR=0.9, SVC_FULL_ROWS=300,
             SVC_FULL_CAP=1275,
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
    # each kernel held against its plain version at the routes' inputs
    assert set(kernels) == {"l2_topk", "l2_topk_bf16", "sorted_topk",
                            "adc_probe", "adc_topk"}
    for line in ("service scan route: l2_topk torch.bfloat16",
                 "service filtered route: l2_topk torch.bfloat16",
                 "insert scan level 0: l2_topk f32", "flat service: l2_topk",
                 "service wide route B = 1: sorted_topk",
                 "ivf service: adc_probe", "at the reference's widths",
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
