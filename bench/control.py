"""The readings that the limit of ``max_rel_err`` is set from, on the card.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 3]

For each seed, in one process: the cell's inputs at its own size, one
warm-up, then one inference of the program at each step of the traffic through the
timed path (``harness.Cell.infer``), each compared with the float32
reference (the lower reading); and for the first ``--control-seeds``
seeds the control, the reference computed with TF32 on, compared with the
same float32 reference (the upper reading).  One JSON line per seed; the
benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(cell: str, seed: int, control: bool, device) -> dict:
    from bench import harness
    from bench.reference import check
    import torch
    if device.type == "cuda":
        torch.cuda.empty_cache()     # the last seed's cached blocks
    t0 = time.perf_counter()
    c = harness.Cell(harness.cell_spec(cell), seed, device)
    steps = c.inputs.steps
    c.infer(c.inputs.step(0))
    outs = [c.infer(s) for s in range(steps)]
    c.sync()
    t1 = time.perf_counter()
    c.free_program()
    prog, ctrl = [], []
    for s in range(steps):
        ref = c.reference(s)
        prog.append(check.max_rel_err(outs[s], ref))
        if control:
            ctrl.append(check.max_rel_err(c.reference(s, "tf32"), ref))
        del ref
    return {"cell": cell, "seed": seed, "program": max(prog),
            "program_by_step": prog,
            "control": max(ctrl) if ctrl else None,
            "control_by_step": ctrl,
            "program_s": t1 - t0, "check_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(args.workload, seed,
                                  i < args.control_seeds, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
