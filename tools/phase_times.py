#!/usr/bin/env python3
"""Per-phase seconds of ``chip_smoke.py``, for one or more checkouts.

    python3 tools/phase_times.py --out chiprun_out/phase_times.json \\
        parent=build/parent change=. change=. parent=build/parent

Runs ``python3 -u chip_smoke.py`` from each checkout in turn (one card,
one run at a time), stamps every line of its standard output with the
seconds since that run started, and cuts the run into phases at the first
line of each landmark record below.  A phase whose landmark a checkout
does not print (an older tree without phase 5d) reads null, and its time
falls into the next phase.  Writes each run's stamped output beside
``--out`` and a summary to ``--out``; exits non-zero if a run failed.
"""
import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

# (phase, the record that ends it); the last phase ends with the run
PHASES = [("build", "build"),
          ("bundle, phase 2 kernels", "main_path_launches"),
          ("phases 3-5", "gcn_path"),
          ("phase 5b GAT", "gat_csr_path"),
          ("phase 5c serving", "tile_nnz_batched_vs_per_slot"),
          ("phase 5d continuous", "continuous_full_width"),
          ("phase 5e mini-batch", "minibatch_stream"),
          ("phase 5f simulator", "simulator_phase"),
          ("phase 6, engine times", "lm_bundle"),
          ("phases 7-8 LM kernels, scoring", "lm_score"),
          ("phase 9 LM serving", "lm_serve"),
          ("phase 9b LM smoke config", "lm_smoke"),
          ("kernels line", None)]


def run_one(name: str, root: Path, log: Path, timeout: float) -> dict:
    t0 = time.monotonic()
    first = {}
    with open(log, "w") as out, open(log.with_suffix(".err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                                cwd=root, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        watchdog = threading.Timer(timeout, proc.kill)
        watchdog.start()
        try:
            for line in proc.stdout:
                t = time.monotonic() - t0
                out.write(f"{t:.3f} {line}")
                if line.startswith('{"record": "'):
                    kind = line[len('{"record": "'):].split('"', 1)[0]
                    first.setdefault(kind, t)
            rc = proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    total = time.monotonic() - t0
    seconds, prev = {}, 0.0
    for phase, landmark in PHASES:
        end = total if landmark is None else first.get(landmark)
        if end is None:
            seconds[phase] = None
            continue
        seconds[phase] = end - prev
        prev = end
    return {"name": name, "root": str(root), "rc": rc, "total_s": total,
            "phase_s": seconds, "log": str(log)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--timeout", type=float, default=1100.0,
                    help="seconds allowed to each run")
    ap.add_argument("runs", nargs="+", help="NAME=CHECKOUT, run in order")
    args = ap.parse_args()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi"
    args.out.parent.mkdir(parents=True, exist_ok=True)
    results = []
    for i, spec in enumerate(args.runs):
        name, _, root = spec.partition("=")
        log = args.out.with_name(f"{args.out.stem}.{i}.{name}.log")
        res = run_one(name, Path(root).resolve(), log, args.timeout)
        print(json.dumps(res), flush=True)
        results.append(res)
    args.out.write_text(json.dumps({"card": card, "runs": results},
                                   indent=1) + "\n")
    print(card)
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
