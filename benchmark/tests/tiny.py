"""A copy of the benchmark at a size the CPU holds, for the tests: every
configuration at 5,000 rows on the CPU (``ivf_k`` 64, 256 wide seeds),
every traffic mix at 32-query requests from a pool of 3, one warm-up and two
traced requests, and full scans at the tiny ``ivf_k``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
ROWS = 5000
IVF_K = 64


def make_tiny_root(dest: Path) -> Path:
    """The tiny copy under ``dest``; returns its benchmark folder."""
    bench = dest / BENCH_DIR.name
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(rows=ROWS, device="cpu")
        if cfg["index"]["type"] == "ivf":
            cfg["index"]["ivf_k"] = IVF_K
        if "wide" in cfg["index"]:
            cfg["index"]["wide"]["seeds"] = 256
        path.write_text(json.dumps(cfg))
    for path in (bench / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(batch=32, pool_requests=3, warmup_requests=1,
                 trace_requests=2)
        if t.get("params", {}).get("n_probe", 0) >= IVF_K:
            t["params"]["n_probe"] = IVF_K
        path.write_text(json.dumps(t))
    return bench
