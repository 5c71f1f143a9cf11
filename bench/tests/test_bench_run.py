"""``run.py`` refuses to run without a card or without the program, and a
run with the timed path broken underneath comes out not correct."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import harness
from conftest import SMALL

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "sage-flickr.feature-refresh", "--seed", "3",
        "--seconds", "1", "--trace", "0"]


def run_py(cwd: Path, env=None):
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = run_py(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_run_exits_nonzero_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = run_py(tmp_path, env)
    assert res.returncode != 0 and res.stdout.strip() == ""


def small_run(cell, monkeypatch=None, fault=None):
    from repro_torch.core import runtime
    if fault is not None:
        real = runtime.FusedModelExecutor.run
        memory = {}

        def broken(self, compiled, tensors):
            env, rep = real(self, compiled, tensors)
            last = compiled.graph.kernels[-1].out
            env[last] = fault(env[last].clone(), memory)
            return env, rep
        monkeypatch.setattr(runtime.FusedModelExecutor, "run", broken)
    return harness.run_cell(cell, 123, 0.2, False, device=torch.device("cpu"),
                            t_start=time.perf_counter(),
                            overrides=SMALL[cell])


def half_left_out(out, memory):
    """Half of the vertices' rows never computed."""
    out[out.shape[0] // 2:] = 0.0
    return out


def answer_altered(out, memory):
    """One logit altered where it is produced."""
    out[out.shape[0] // 3, 0] += 0.01 * out.abs().max()
    return out


def state_unchanged(out, memory):
    """The previous inference's answer returned again: the new features
    never reach the result."""
    prev = memory.get("prev", out)
    memory["prev"] = out
    return prev


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    out = small_run(cell)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in
                                   harness.cell_metrics(cell, False)}
    json.dumps(out)


@pytest.mark.parametrize("fault", [half_left_out, answer_altered,
                                   state_unchanged],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    out = small_run(cell, monkeypatch, fault)
    assert not out["correct"] and out["failed"] > 0
    check = out["checks"]["max_rel_err"]
    assert check["value"] > check["limit"]


@pytest.mark.card
def test_a_short_traced_run_on_the_card(card):
    cell = "sage-flickr.feature-refresh"
    out = harness.run_cell(cell, 5, 1.0, True, device=card,
                           t_start=time.perf_counter(),
                           overrides=SMALL[cell])
    assert out["correct"]
    assert out["device"]["busy_s"] > 0
    for name in ("launches_per_infer", "profile_ms", "idle_share"):
        assert name in out["metrics"]


@pytest.mark.parametrize("key,value", [("kind", "model-refresh"),
                                       ("kind", "no-such-kind"),
                                       ("loop", "open"), ("clients", 2),
                                       ("order", "shuffled")])
def test_a_traffic_the_harness_does_not_know_is_refused(key, value,
                                                        monkeypatch):
    """A mix of an unknown kind, loop, client count or order, or of a kind
    whose parameters it does not state (``model-refresh`` without
    ``weight_sets``), raises rather than running as another mix."""
    cell = "sage-flickr.feature-refresh"
    real = harness.cell_spec

    def spec(name, overrides=None):
        out = real(name, overrides)
        out["traffic"] = {**out["traffic"], key: value}
        return out
    monkeypatch.setattr(harness, "cell_spec", spec)
    with pytest.raises((LookupError, ValueError)):
        harness.run_cell(cell, 7, 0.1, False, device=torch.device("cpu"),
                         t_start=time.perf_counter(), overrides=SMALL[cell])
