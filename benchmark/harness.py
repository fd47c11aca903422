"""One run of one benchmark cell: set-up, the timed window, the checks
against the plain reference, and the result line.

The harness is driven by data. ``BENCHMARK.json`` names the cell; the cell
names its configuration, a JSON file (the deployment's sizes, its data
recipe, the service's settings and the limits of the checks) that the
service reads as its own config file, and its traffic mix,
``traffic/<name>.json`` (batch, k, the request's parameters, the query pool,
warm-up and traced requests, the cell's limit of missed neighbours). The data recipe names a
generator, ``generators/<name>.py``; each metric of ``BENCHMARK.json`` is
read by ``metrics/<name>.py``. A new configuration, traffic mix, cell or
metric is new files and new entries, and no edit here.

Traffic: one client in a closed loop. A request is one ``search_batch`` of
``batch`` queries, timed from its issue until its distances and ids are on
the host. Queries come from a pool drawn in set-up (held out of the corpus,
on the host as numpy); a window that uses the pool up cycles through it.

``correct``: every answer of the window is held to the plain reference
(``reference/exact.py``), which recomputes from the benchmark's own corpus:

- ``dist_err``: the largest relative gap between a returned distance and
  the reference's float64 distance of the same (query, row) pair;
- ``bad_answers``: queries whose answer breaks its form: fewer than k rows,
  a row that is not in the corpus, a row twice, distances not ascending or
  not finite;
- ``recall_miss``: the share of the exact top-k that the answers miss
  (1 - recall), so that distinct rows at their true distances from too
  small a part of the corpus still fail;

and no request may fail. Recall compares the ids with the reference's exact
top-k, over every request of the window or, where that is more work than
``REF_FLOPS``, over a sample of the requests drawn from the seed, never
under a tenth of them. It is also the end-to-end metric ``recall``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import guard
from benchmark.reference import exact
from benchmark.trace import SERVICE_SPAN, WINDOW_SPAN, Trace

REF_FLOPS = 1e14        # the recall reference's budget of products a run
SAMPLE_FLOOR = 0.1      # the least share of requests the recall samples
DIST_FLOOR = 1e-9       # a distance under this is compared absolutely
POOL_CHUNK = 1 << 18    # query rows drawn on the device at a time


class GuardError(RuntimeError):
    """A forbidden module (JAX, or the JAX package) is loaded."""


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_module(path: Path):
    """The module in file ``path`` (a name may hold dots, as a metric's)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    spec: dict              # the cell's entry of BENCHMARK.json
    bench: dict             # all of BENCHMARK.json
    config_path: Path
    config: dict
    traffic: dict
    bench_dir: Path         # the benchmark's folder: generators, metrics

    def metrics(self, section: str) -> List[dict]:
        """The metrics of ``section`` (end_to_end or per_layer) that this
        cell reports."""
        return [m for m in self.bench[section]
                if self.name in m.get("workloads", [self.name])]


def load_cell(bench_dir: Path, workload: str) -> Cell:
    root = bench_dir.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    spec = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[spec["config"]]
    config_path = root / entry["file"]
    traffic = json.loads(
        (bench_dir / "traffic" / f"{spec['traffic']}.json").read_text())
    return Cell(workload, spec, bench, config_path,
                json.loads(config_path.read_text()), traffic, bench_dir)


def make_requests(cell: Cell, seed: int, device) -> tuple:
    """(corpus on the host f32[rows, dim], query pool f32[pool, batch,
    dim], warm-up requests f32[warm, batch, dim]): drawn on ``device`` from
    the seed by the configuration's generator."""
    cfg, trf = cell.config, cell.traffic
    rows, dim, b = int(cfg["rows"]), int(cfg["dim"]), int(trf["batch"])
    pool, warm = int(trf["pool_requests"]), int(trf["warmup_requests"])
    make = load_module(cell.bench_dir / "generators"
                       / f"{cfg['data']['generator']}.py").make
    params = cfg["data"]["params"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    src = make(dim, params, gen, device)
    if "corpus_seed" in cfg["data"]:
        # a corpus fixed by the configuration; the run's seed, on a stream
        # that can never be the corpus's (past 2^63), draws the queries
        fixed = torch.Generator(device=device)
        fixed.manual_seed(int(cfg["data"]["corpus_seed"]))
        corpus_host = make(dim, params, fixed, device).rows(
            rows).cpu().numpy()
        gen.manual_seed((int(seed) % (1 << 63)) | (1 << 63))
    else:
        corpus_host = src.rows(rows).cpu().numpy()
    q = np.empty((pool + warm, b, dim), np.float32)
    flat = q.reshape(-1, dim)
    for s in range(0, flat.shape[0], POOL_CHUNK):
        part = flat[s:s + POOL_CHUNK]
        torch.from_numpy(part).copy_(src.rows(part.shape[0]))
    return corpus_host, q[:pool], q[pool:]


@dataclass
class Answer:
    pool_index: int
    latency_s: float
    dists: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window_s: float
    answers: List[Answer]
    traced: int = 0          # the first ``traced`` requests ran traced
    recall: Optional[float] = None
    trace: Optional[Trace] = None

    @property
    def latencies_s(self) -> List[float]:
        """The untraced requests' latencies, failed ones included."""
        return [a.latency_s for a in self.answers[self.traced:]]

    @property
    def queries_answered(self) -> int:
        return sum(a.ids.shape[0] for a in self.answers if a.ids is not None)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def run_window(server: Callable, queries: np.ndarray, k: int, params: dict,
               seconds: float, trace_requests: int, device):
    """The closed loop: requests back to back until ``seconds`` have
    passed, the first ``trace_requests`` under the profiler. Returns
    (answers, window seconds, failed, profiler or None). The window closes
    when the last request started in it has returned."""
    answers: List[Answer] = []
    failed = 0
    pool = queries.shape[0]

    def issue(i: int, span: bool) -> None:
        nonlocal failed
        p = i % pool
        ctx = (torch.profiler.record_function(SERVICE_SPAN) if span
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with ctx:
                d, ids = server(queries[p], k, params)
        except Exception:  # a failed request is counted, not fatal
            failed += 1
            if failed == 1:
                log("request failed:\n" + traceback.format_exc())
            answers.append(Answer(p, time.perf_counter() - t0))
            return
        answers.append(Answer(p, time.perf_counter() - t0,
                              np.asarray(d), np.asarray(ids)))

    t_open = time.perf_counter()
    deadline = t_open + seconds
    prof = None
    if trace_requests:
        prof = _profiler(device)
        prof.start()
        with torch.profiler.record_function(WINDOW_SPAN):
            for i in range(trace_requests):
                issue(i, True)
        prof.stop()
    i = len(answers)
    while time.perf_counter() < deadline:
        issue(i, False)
        i += 1
    return answers, time.perf_counter() - t_open, failed, prof


def check_answers(cell: Cell, corpus: torch.Tensor, queries: np.ndarray,
                  answers: List[Answer], seed: int) -> Dict[str, float]:
    """The numbers compared with the reference (``dist_err``,
    ``bad_answers``, ``recall_miss``) and the recall over the sampled
    requests."""
    rows, k = corpus.shape[0], int(cell.traffic["k"])
    b = queries.shape[1]
    dist_err, bad = 0.0, 0
    done = [a for a in answers if a.ids is not None]
    for a in done:
        if a.ids.shape != (b, k) or a.dists.shape != (b, k):
            bad += b
            continue
        ids, d = a.ids.astype(np.int64), a.dists.astype(np.float64)
        inside = (ids >= 0) & (ids < rows)
        wrong = ~inside.all(1) | ~np.isfinite(d).all(1)
        srt = np.sort(ids, axis=1)
        wrong |= (srt[:, 1:] == srt[:, :-1]).any(1)
        with np.errstate(invalid="ignore"):   # inf - inf: caught above
            wrong |= (np.diff(d, axis=1) < 0).any(1)
        bad += int(wrong.sum())
        ok = torch.from_numpy(inside)
        ref = exact.pair_distances(
            corpus, torch.from_numpy(queries[a.pool_index]),
            torch.from_numpy(np.where(inside, ids, 0))).cpu()
        gap = (torch.from_numpy(d) - ref).abs() / ref.clamp_min(DIST_FLOOR)
        gap = torch.where(ok & torch.from_numpy(np.isfinite(d)), gap, 0.0)
        dist_err = max(dist_err, float(gap.max()))
    out = {"dist_err": dist_err, "bad_answers": bad, "recall_miss": 1.0}
    if not done:
        return out
    per_req = 2.0 * b * rows * corpus.shape[1]
    take = len(done)
    if take * per_req > REF_FLOPS:
        take = max(math.ceil(SAMPLE_FLOOR * len(done)),
                   int(REF_FLOPS // per_req))
    pick = np.sort(np.random.default_rng(seed).permutation(len(done))[:take])
    hits = 0
    for j in pick:
        a = done[j]
        _, truth = exact.topk(corpus, torch.from_numpy(
            queries[a.pool_index]), k)
        got = torch.from_numpy(a.ids.astype(np.int64)).to(corpus.device)
        hits += int((got[:, :, None] == truth[:, None, :]).any(2).sum())
    out["recall"] = hits / (len(pick) * b * k)
    out["recall_miss"] = 1.0 - out["recall"]
    out["recall_requests"] = len(pick)
    return out


def run_cell(bench_dir: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             serve: Optional[Callable] = None) -> dict:
    """One run; the result line's object. ``serve(cell, corpus, device)``
    makes the server that answers requests: the program by default (the
    control puts the reference in its place). Raises GuardError when a
    forbidden module is loaded after set-up or at the end."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cell = load_cell(bench_dir, workload)
    trf = cell.traffic
    k, params = int(trf["k"]), dict(trf.get("params", {}))
    t = time.perf_counter()
    corpus, pool, warm = make_requests(cell, seed, device)
    log(f"corpus {corpus.shape} and {pool.shape[0]} pooled requests "
        f"drawn in {time.perf_counter() - t:.2f} s")
    if device.type == "cuda":   # the draw's buffers are not the program's
        torch.cuda.reset_peak_memory_stats(device)
    if serve is None:
        from benchmark.program import ProgramServer

        server = ProgramServer(cell.config_path, corpus, device, log)
    else:
        server = serve(cell, corpus, device)
    t = time.perf_counter()
    for w in warm:
        server(w, k, params)
    log(f"warm-up of {warm.shape[0]} requests in "
        f"{time.perf_counter() - t:.2f} s")
    _guard("after set-up")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    traced = int(trf["trace_requests"]) if trace else 0
    answers, window_s, failed, prof = run_window(
        server, pool, k, params, seconds, traced, device)
    run = Run(cell, setup_s, window_s, answers, traced)
    log(f"window: {len(answers)} requests, {run.queries_answered} queries "
        f"in {window_s:.3f} s, {failed} failed; set-up {setup_s:.2f} s")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if prof is not None:
        run.trace = Trace.from_profile(prof, traced)
        del prof
    server.release()
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check_answers(cell, torch.from_numpy(corpus).to(device), pool,
                           answers, seed)
    log(f"reference checks in {time.perf_counter() - t:.2f} s: recall "
        f"{checks.get('recall')} over {checks.get('recall_requests', 0)} of "
        f"{len(answers)} requests")
    run.recall = checks.get("recall")
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(section):
        value = load_module(bench_dir / "metrics" / f"{m['name']}.py").read(
            run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = {**cell.config["checks"], **trf["checks"]}
    compared = {name: {"value": checks[name], "limit": limits[name]}
                for name in ("dist_err", "bad_answers", "recall_miss")}
    correct = (failed == 0 and len(answers) > 0
               and all(c["value"] <= c["limit"] for c in compared.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell.spec["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(answers),
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = compared
    _guard("at the end")
    for name, c in compared.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    return result


def _guard(when: str) -> None:
    found = guard.forbidden_modules()
    if found:
        raise GuardError(f"forbidden modules loaded {when}: {found}")
