"""Run one cell of the benchmark of ``tpu_sparse_lu_torch`` once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and ``checks``, the numbers
the output check compared with their limits, which are also the last
lines on standard error. Exits non-zero, printing no result, without a
CUDA card, with fewer cards than the cell asks for, when the program is
not the checkout's own, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's program and benchmark, never an installed copy
sys.path.insert(0, str(ROOT))
# build and kernel caches at fixed paths inside the checkout
_CACHE = ROOT / ".h100_bench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)


def fail(code: int, msg: str):
    print(f"h100_bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from h100_bench import harness

    bench = harness.Bench.load(ROOT)
    chips = bench.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available():
        fail(3, "no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        fail(3, f"{args.workload} needs {chips} cards, "
                f"{torch.cuda.device_count()} found")
    try:
        import tpu_sparse_lu_torch
    except ImportError as e:
        fail(5, f"the program is missing from the checkout: {e}")
    where = Path(tpu_sparse_lu_torch.__file__).resolve()
    if ROOT not in where.parents:
        fail(5, f"{harness.PROGRAM} loaded from {where}, not from {ROOT}")

    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T0)
    found = harness.forbidden_modules()
    if found:
        fail(4, f"modules of JAX or the JAX package were loaded: {found}")
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
