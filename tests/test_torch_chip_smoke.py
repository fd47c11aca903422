"""A CPU rehearsal of chip_smoke.py's phase 6 (the port's services at the
config.yaml deployment) at a tiny size, so a broken phase shows before a
chip call: the phase's sizes cut down, the card's calls (synchronize,
memory stats, its name, the profiler) stubbed, the services' device taken
to the CPU, and the kernel wrappers (which run their plain versions on the
CPU and launch nothing) replaced by ones that count as a launch would.
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
from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk
from vector_db_tpu_torch.ops.cuda.sorted_topk import sorted_topk

SIZES = dict(SVC_N=5100, SVC_DIM=32, SVC_QUERIES=64, SVC_BATCH=100,
             SVC_SINGLE=3, SVC_DELETE=10, SVC_SCAN_THRESHOLD=32,
             SVC_WIDE_B=16, SVC_SINGLE_Q=5, SVC_MIN_SIZE=1024,
             SVC_SMALL_N=2000, SVC_IVF_K=16, SVC_PQ_M=8, HNSW_EFC=64,
             HNSW_M=8, SVC_WIDE_FLOOR=0.9, SVC_FULL_ROWS=300,
             SVC_HTTP={"embed": 2, "batch_docs": 1, "batch_docs_size": 5,
                       "search": 3, "search_batch": 1, "health": 2,
                       "stats": 1})


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

    kernels = {}
    chip_smoke.phase_services(torch, kernels, "card, 700 W")
    out = capsys.readouterr().out
    assert "services summary" in out and "[card, 700 W]" in out
    bare = [line for line in out.strip().splitlines()
            if not line.endswith("[card, 700 W]")]
    assert not bare, bare
    assert l2_topk.launches > 0 and l2_topk.launches_bf16 > 0
    assert sorted_topk.launches > 0 and adc_probe_scores.launches > 0
    # each kernel held against its plain version at the routes' inputs
    assert set(kernels) == {"l2_topk", "l2_topk_bf16", "sorted_topk",
                            "adc_probe"}
    for line in ("service scan route: l2_topk torch.bfloat16",
                 "service filtered route: l2_topk torch.bfloat16",
                 "insert scan level 0: l2_topk f32", "flat service: l2_topk",
                 "service wide route B = 1: sorted_topk",
                 "ivf service: adc_probe", "at the reference's widths"):
        assert line in out, line
    assert np.isfinite(chip_smoke.SCAN_FLOOR)
