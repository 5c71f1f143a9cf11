"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, the last of standard output, and the
numbers of the correctness check beside their limits as the last lines of
standard error.  Exits non-zero, printing no result, without a card (or
with fewer than the cell asks for), without the program, or when the run's
process holds jax, jaxlib, flax or the JAX package ``repro`` after the
window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench import harness

    chips = harness.chips_of(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here without the program)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device=torch.device("cuda", 0),
                           t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: the run's process holds {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
