"""The reader of the walk-format hit counter (``repro_torch.trace``
``bitmask_reused_bytes``): GB per inference over the program's ``runs``,
None on a zero count, without ``runs``, or where the program has no such
module or counter."""
import sys

import pytest

from bench import harness

NAME = "bitmask_reused_gb_per_infer"
MADE_UP = {"runs": 8, "bitmask_bytes": 4 * 10 ** 11,
           "bitmask_reused_bytes": 2 * 10 ** 11}


@pytest.fixture
def counters(monkeypatch):
    from repro_torch import trace
    made = {}
    monkeypatch.setattr(trace, "counters", lambda: dict(made))
    return made


def test_reader_ratio(counters):
    counters.update(MADE_UP)
    assert harness.reader(NAME)({}) == pytest.approx(25.0, rel=1e-12)


@pytest.mark.parametrize("absent", [
    {"bitmask_reused_bytes": 0}, {"runs": 0}, "no_counter", "nothing"])
def test_reader_none_without_a_count(counters, absent):
    counters.update(MADE_UP)
    if absent == "no_counter":
        del counters["bitmask_reused_bytes"]
    elif absent == "nothing":
        counters.clear()
    else:
        counters.update(absent)
    assert harness.reader(NAME)({}) is None


def test_reader_without_the_program_module(monkeypatch, counters):
    """A program without ``repro_torch.trace`` (an older commit): None,
    no raise."""
    import repro_torch
    counters.update(MADE_UP)
    assert harness.reader(NAME)({}) is not None
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert harness.reader(NAME)({}) is None
