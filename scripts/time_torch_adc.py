"""Time the port's two ADC kernels of several checkouts on one GPU, in turns.

    python scripts/time_torch_adc.py --root OLD --root NEW --root NEW --root OLD

Each ``--root`` is a checkout of this repository (e.g. a ``git archive`` of
an earlier commit unpacked into ``build/``). For each, in the order given, a
fresh process imports that checkout's ``vector_db_tpu_torch``, builds its
kernels into the checkout's own ``build/kernels/``, and times, with this
checkout's ``chip_smoke.cuda_ms`` (CUDA events around back-to-back calls):

- ``adc_topk`` at chip_smoke's main shape: N = 2^20 int32 codes, m = 16,
  ksub = 256, B = 128, k = 100, every 97th row invalid; and at B = 100,
  which leaves query slots of the last group empty;
- ``adc_probe_scores`` at the IVF-PQ probe's shape: B = 64 queries, P = 16
  cells x 978 slots, m = 16, each cell live for a prefix of 0-488 slots
  (a mean list of ~244, as the SIFT1M build gives), its inputs read from
  HBM (``chip_smoke.l2_cold``) and from L2 (one set back to back).

Inputs come from a seeded generator on the card, the same for every root.
One JSON line per root; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location(
        "smoke_timing", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from vector_db_tpu_torch.ops.cuda.adc_probe import adc_probe_scores
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk

    assert Path(sys.modules["vector_db_tpu_torch"].__file__).is_relative_to(
        Path(root).resolve())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, b, k = 1 << 20, 128, 100
    lut = torch.randn(b, 16, 256, generator=gen, device=dev) ** 2
    codes = torch.randint(0, 256, (n, 16), generator=gen, device=dev,
                          dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[::97] = False
    pb, cells, width = 64, 16, 978
    plut = torch.randn(pb, 16, 256, generator=gen, device=dev) ** 2
    pcodes = torch.randint(0, 256, (pb, cells * width, 16), generator=gen,
                           device=dev, dtype=torch.uint8)
    corr = torch.randn(pb, cells * width, generator=gen, device=dev)
    live = torch.randint(0, width // 2, (pb, cells, 1), generator=gen,
                         device=dev)
    pvalid = (torch.arange(width, device=dev) < live).reshape(pb, -1)
    return {
        "root": root,
        "adc_topk_ms": smoke.cuda_ms(torch, lambda: adc_topk(lut, codes,
                                                             valid, k)),
        "adc_topk_b100_ms": smoke.cuda_ms(torch, lambda: adc_topk(
            lut[:100], codes, valid, k)),
        "adc_probe_ms": smoke.cuda_ms(torch, smoke.l2_cold(
            torch, adc_probe_scores, plut, pcodes, corr, pvalid)),
        "adc_probe_l2_ms": smoke.cuda_ms(torch, lambda: adc_probe_scores(
            plut, pcodes, corr, pvalid)),
        "probe_live": int(pvalid.sum()),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=[])
    ap.add_argument("--one")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for root in args.root:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
