"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout, on the card(s) of the machine it is
started on. Prints logs on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; last, ``checks``: each number
compared with the plain reference beside its limit.

Exits non-zero and prints no result without enough CUDA devices for the
cell, or when JAX or the JAX package (``vector_db_tpu``) is loaded.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(BENCH_DIR, args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); torch "
                    f"sees {torch.cuda.device_count()}")
        return 2
    try:
        result = harness.run_cell(BENCH_DIR, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  torch.device("cuda", 0), T_START)
    except harness.GuardError as e:
        harness.log(str(e))
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
