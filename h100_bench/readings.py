"""The readings the output check's limits are set from.

    python3 h100_bench/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 1 [--first-seed N] [--out FILE]

Builds the cell once, then for each seed makes the seed's ring, runs a
short window at the cell's own load, and judges the sampled answers as a
run does: the program's readings. For the first ``--control-seeds`` seeds
it also judges the control on the same sampled inputs: the reference put
in the program's place and computed in TF32 (the configuration's
``control``, ``reference/<control>.py``). Prints one JSON object: per seed, the
widest of each compared number, for the program and the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402


def widest(judged):
    return {k: max(j[k] for j in judged) for k in judged[0]}


def control(bench, cfg: dict, A, kept: list, device) -> list:
    """``kept`` with each answer replaced by the control's: the reference
    computed in TF32 on the same matrix and right-hand sides (one
    factorization per distinct matrix)."""
    import numpy as np

    ctl = bench.module("reference", cfg["control"])
    out = list(kept)
    for As, js in harness.by_matrix(A, kept):
        X = ctl.solve(As, np.concatenate(
            [kept[j][1] for j in js], axis=1), device)
        col = 0
        for j in js:
            r = kept[j][1].shape[1]
            out[j] = (kept[j][0], kept[j][1], X[:, col:col + r])
            col += r
    return out


def readings(bench, cell: str, seeds, control_seeds: int, seconds: float,
             device) -> dict:
    """``{"program": [...], "control": [...]}``: per seed, the seed and
    the widest of each compared number over the sampled answers."""
    c = bench.cell(cell)
    cfg = bench.data("configs", c["config"])
    traffic = bench.data("traffic", c["traffic"])
    s = harness.setup(bench, cell, seeds[0], device)
    out = {"program": [], "control": []}
    for n, seed in enumerate(seeds):
        s.ring = harness.Ring.make(s.A, traffic, seed, device, s.ring.b.dtype)
        sample = harness.Sample(harness.SAMPLE, seed)
        steps, _, _, _ = harness.window(s, seconds, sample, device)
        kept = harness.host_copies(s, sample)
        out["program"].append({"seed": seed, "steps": steps,
                               **widest(harness.judge(bench, cfg, s.A, kept,
                                                      device))})
        if n < control_seeds:
            out["control"].append({"seed": seed, **widest(harness.judge(
                bench, cfg, s.A, control(bench, cfg, s.A, kept, device),
                device))})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("h100_bench: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    res = {"workload": args.workload,
           "device": torch.cuda.get_device_name(0),
           **readings(harness.Bench.load(ROOT), args.workload, seeds,
                      args.control_seeds, args.seconds, "cuda")}
    text = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
