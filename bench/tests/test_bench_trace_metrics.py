"""The readers of the program's own counters (``repro_torch.trace``): each
divides by the program's ``runs`` where it is a rate, returns None on a
zero count, and returns None where the program has no such module."""
import sys

import pytest

from bench import harness

RUNS = 8
MADE_UP = {"runs": RUNS, "bitmask_bytes": 4 * 10 ** 11,
           "bitmask_repeat_bytes": 3 * 10 ** 11,
           "walk_scratch_bytes": 3 * 2 ** 30, "profile_bytes": 2 * 10 ** 9,
           "run_host_ns": 12_000_000, "host_syncs": 8, "launch.dispatch": 48}
# (reader, counter it needs, value on MADE_UP)
READERS = [
    ("bitmask_gb_per_infer", "bitmask_bytes", 50.0),
    ("bitmask_repeat_pct", "bitmask_bytes", 75.0),
    ("walk_scratch_gib", "walk_scratch_bytes", 3.0),
    ("profiled_gb_per_infer", "profile_bytes", 0.25),
    ("host_ms_per_infer", "run_host_ns", 1.5),
    ("syncs_per_infer", "host_syncs", 1.0),
]


@pytest.fixture
def counters(monkeypatch):
    from repro_torch import trace
    made = {}
    monkeypatch.setattr(trace, "counters", lambda: dict(made))
    return made


@pytest.mark.parametrize("name,needs,want", READERS)
def test_reader_ratio_and_zero(counters, name, needs, want):
    read = harness.reader(name)
    counters.update(MADE_UP)
    assert read({}) == pytest.approx(want, rel=1e-12)
    counters[needs] = 0
    assert read({}) is None
    counters.clear()
    assert read({}) is None


def test_rates_need_runs(counters):
    counters.update(MADE_UP, runs=0)
    for name, _, _ in READERS:
        if name.endswith("_per_infer"):
            assert harness.reader(name)({}) is None, name


def test_repeat_share_reads_zero_without_repeats(counters):
    counters.update(MADE_UP, bitmask_repeat_bytes=0)
    assert harness.reader("bitmask_repeat_pct")({}) == 0.0


@pytest.mark.parametrize("name", [r[0] for r in READERS])
def test_reader_without_the_program_module(monkeypatch, counters, name):
    """A program without ``repro_torch.trace`` (an older commit): None,
    no raise."""
    import repro_torch
    counters.update(MADE_UP)
    assert harness.reader(name)({}) is not None
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert harness.reader(name)({}) is None
