"""One run of one cell: set-up, the measured window, the check, the line.

The program under test is ``repro_torch``, reached through the program
family that the cell's configuration names (``family``:
``programs/<family>.py``, whose ``Program`` builds the resident inputs and
the traffic's ``inputs``, compiles and holds the program, runs one step
(``infer``), frees it, and gives the plain reference's output and the
needed work of each step).  Everything a cell needs is found by name: the
workload (``workloads/<cell>.json``: the pair and the limits), its
configuration (``configs/<config>.json``: the family, the model, the
program's settings), its traffic mix (``traffic/<mix>.json``: parameters
only), the mix's kind (``traffic/kinds/<kind>.py``: the inputs of each
step), the loop that offers it (``traffic/loops/<loop>.py``: the window)
and each metric's reader (``metrics/<metric>.py``); an unknown name
raises.

Set-up (``setup_s``): CUDA, the program's kernels, the family's resident
inputs and the traffic's inputs (from the configuration and the run's
seed, on the card), the compile, and a warm-up over the cell's own
shapes.  The loop then measures for ``seconds``.  After the window the
peak memory is read, the program is freed, and the reference is worked
out step by step and compared with the outputs that the window kept
(``reference/check.py``).  With ``trace`` a profiler window follows the
measured one (``trace.py``), and the work counts are taken after it.
"""
from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from bench import plugins
from bench import trace as tracing
from bench.reference import check, work
from bench.traffic import generator

BENCH = plugins.BENCH
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(cell: str, overrides: Optional[dict] = None) -> dict:
    """The workload, its configuration and its traffic, found by name;
    ``overrides`` replace keys of the configuration (the tests' small
    sizes)."""
    wl = load(BENCH / "workloads" / f"{cell}.json")
    cfg = load(BENCH / "configs" / f"{wl['config']}.json")
    cfg.update(overrides or {})
    traffic = load(BENCH / "traffic" / f"{wl['traffic']}.json")
    return {"cell": cell, "workload": wl, "config": cfg, "traffic": traffic}


def cell_metrics(cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports, as ``BENCHMARK.json`` lists
    them: its end-to-end metrics, or with ``traced`` its per-layer ones."""
    spec = load(SPEC)
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def chips_of(cell: str) -> int:
    return next(w["chips"] for w in load(SPEC)["workloads"]
                if w["name"] == cell)


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return plugins.load("metrics", name).read


class Cell:
    """One run's program (``program``, of the family its configuration
    names), its traffic's inputs (``inputs``) and the loop that offers
    them."""

    def __init__(self, spec: dict, seed: int, device: torch.device):
        cfg, traffic = spec["config"], spec["traffic"]
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = seed, device
        self.loop = plugins.load("traffic/loops", traffic["loop"])
        self.program = plugins.load("programs", cfg["family"]).Program(
            cfg, traffic, seed, device)
        self.inputs = self.program.inputs

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def infer(self, s: int) -> torch.Tensor:
        """One step of the program at step ``s``; returns the output
        that is checked."""
        return self.program.infer(s)

    def free_program(self) -> None:
        """Drop the program's objects and state; the inputs stay."""
        self.program.free_program()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, s: int, precision: str = "float32") -> torch.Tensor:
        """The plain reference's output at step ``s``."""
        return self.program.reference(s, precision)


def device_peaks(device: torch.device, name: str) -> Optional[dict]:
    """The published peaks of the card named ``name``; None off a card."""
    return work.peaks(name) if device.type == "cuda" else None


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        and res.stdout.strip() else None


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: str, seed: int, seconds: float, traced: bool, *,
             device: torch.device, t_start: float,
             overrides: Optional[dict] = None) -> dict:
    """Set-up, window, check; returns the result line's object (with the
    checks last).  ``t_start`` is when the process began (``setup_s``
    counts from it)."""
    cs = cell_spec(cell, overrides)
    metrics = cell_metrics(cell, traced)
    limits = cs["workload"]["limits"]
    t_cell = time.perf_counter()
    c = Cell(cs, seed, device)
    t_warm = time.perf_counter()
    warm = cs["traffic"]["warmup_inferences"]
    for i in range(warm):
        c.infer(c.inputs.step(i))
    c.sync()
    print(f"setup: process and CUDA {t_cell - t_start:.3f} s, inputs and "
          f"compile {t_warm - t_cell:.3f} s, warm-up "
          f"{time.perf_counter() - t_warm:.3f} s", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    from repro_torch import kernels as program_kernels
    program_kernels.reset_launch_counts()
    setup_s = time.perf_counter() - t_start

    win = c.loop.window(c, seconds, random.Random(
        generator.sub_seed(seed, "sample")), warm)
    launches = dict(program_kernels.launch_counts())
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    prof = None
    if traced:
        # one inference of each step, the run's sequence continued
        steps = c.inputs.steps
        first = warm + len(win["latencies_s"])
        order = [c.inputs.step(first + j) for j in range(steps)]
        prof = tracing.profile_window(
            lambda: [c.infer(s) for s in order], steps, device)
        if prof is not None and not prof["complete"]:
            print(f"trace: no whole window in {prof['windows']}; counts "
                  f"not whole: {prof['partial']}", file=sys.stderr)
    kept = win.pop("kept")
    c.free_program()
    print(f"inputs: {c.program.describe()}", file=sys.stderr)

    errs = {s: check.max_rel_err(kept.get(s), c.reference(s))
            for s in range(c.inputs.steps)}
    del kept
    ctx = {"setup_s": setup_s, "inferences": len(win["latencies_s"]),
           "launches": launches, "peak_mem_bytes": peak, "trace": prof,
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"), **win}
    if traced:
        ctx["work"] = [c.program.work(s) for s in range(c.inputs.steps)]
        ctx["peaks"] = device_peaks(device, ctx["device_name"])
    values = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    worst = max(errs.values())
    limit = limits["max_rel_err"]
    failed = sum(e > limit for e in errs.values())
    out = {"correct": failed == 0, "attempted": ctx["inferences"],
           "failed": failed, "metrics": values,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": ctx["device_name"], "count": 1,
                      "memory_peak_bytes": int(peak)}}
    if device.type == "cuda":
        out["device"]["power"] = power_limit()
    if prof is not None and prof["complete"]:
        out["device"]["busy_s"] = prof["busy_s"]
        out["device"]["window_s"] = prof["window_s"]
        out["breakdown"] = prof["breakdown"]
    out["checks"] = {"max_rel_err": {"value": worst, "limit": limit}}
    return out
