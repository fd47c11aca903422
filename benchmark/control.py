"""The controls of the benchmark's correctness check, run on the card at a
cell's own size to read the limits from; the benchmark's own runs never run
them. Each has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--server bf16|half_index]

- ``bf16`` (the control): the plain reference put in the program's place
  and computed in bfloat16, the precision below the float32 the
  configurations state;
- ``half_index`` (a fault): the program with half of its index left out.
  It ingests the corpus's even rows only, and its answers are mapped back to
  the corpus's row ids: distinct rows at their true distances, in order,
  from half the corpus.

Each seed is one run of the cell as ``run.py`` makes it (the same corpus,
queries, window and checks), with the requests answered by that server.
Prints one JSON line a seed: the seed, ``correct`` and the compared numbers
beside their limits.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.reference import exact  # noqa: E402


class ControlServer:
    """Answers a request with the exact top-k computed in bfloat16 over the
    benchmark's corpus."""

    def __init__(self, cell, corpus: np.ndarray, device) -> None:
        self.corpus = torch.from_numpy(corpus).to(device)

    def __call__(self, queries, k, params):
        d, i = exact.topk(self.corpus, torch.from_numpy(queries), k,
                          dtype=torch.bfloat16)
        return d.cpu().numpy(), i.cpu().numpy()

    def release(self) -> None:
        self.corpus = None


class HalfIndexServer:
    """The program over the corpus's even rows only, its row ids mapped
    back to the corpus's."""

    def __init__(self, cell, corpus: np.ndarray, device) -> None:
        from benchmark import harness
        from benchmark.program import ProgramServer

        self.server = ProgramServer(cell.config_path,
                                    np.ascontiguousarray(corpus[::2]),
                                    device, harness.log)

    def __call__(self, queries, k, params):
        d, ids = self.server(queries, k, params)
        ids = np.asarray(ids)
        return np.asarray(d), np.where(ids >= 0, 2 * ids, ids)

    def release(self) -> None:
        self.server.release()


SERVERS = {"bf16": ControlServer, "half_index": HalfIndexServer}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--server", choices=sorted(SERVERS), default="bf16")
    args = ap.parse_args(argv)

    from benchmark import harness

    if not torch.cuda.is_available():
        harness.log("the control runs on the card")
        return 2
    for seed in args.seeds:
        result = harness.run_cell(
            BENCH_DIR, args.workload, seed, args.seconds, False,
            torch.device("cuda", 0), time.perf_counter(),
            serve=SERVERS[args.server])
        print(json.dumps({"seed": seed, "server": args.server,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
