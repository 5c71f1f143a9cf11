"""Traffic kind ``model-refresh``: the program is handed the same feature
object and fresh weight views, each the step's seeded set, and a timed
path that serves stale or reused weights comes out not correct."""
import time

import pytest
import torch

from bench import harness, plugins
from conftest import SMALL

CELL = "gcn-nell.model-refresh"


@pytest.fixture(scope="module")
def cell():
    return harness.Cell(harness.cell_spec(CELL, SMALL[CELL]), 31,
                        torch.device("cpu"))


def test_the_same_features_and_fresh_weight_views(cell):
    inputs = cell.inputs
    handed = [inputs.program_tensors(s) for s in (0, 1, 1, 2, 0)]
    feats = [t[inputs.features] for t in handed]
    assert all(f is feats[0] for f in feats)
    assert feats[0]._version == inputs.buf._version
    for name in inputs.weights:
        views = [t[name] for t in handed]
        assert len({id(v) for v in views}) == len(views)
        assert all(v.data_ptr() == inputs.weights[name].data_ptr()
                   for v in views)


def test_each_step_hands_its_own_set(cell):
    inputs = cell.inputs
    assert inputs.steps == 8
    for s in (3, 0, 7):
        handed = inputs.program_tensors(s)
        x, sets = inputs.reference_inputs(s)
        assert x is handed[inputs.features]
        for name, w in sets.items():
            assert torch.equal(handed[name], w)
    flat = [torch.cat([w.view(-1) for w in st.values()])
            for st in inputs.sets]
    assert all(not torch.equal(flat[0], f) for f in flat[1:])


def test_the_sets_are_a_function_of_the_seed():
    spec = harness.cell_spec(CELL, SMALL[CELL])
    a, b, c = (harness.Cell(spec, seed, torch.device("cpu")).inputs
               for seed in (2 ** 33 + 1, 2 ** 33 + 1, 5))
    for k in range(a.steps):
        for name in a.sets[k]:
            assert torch.equal(a.sets[k][name], b.sets[k][name])
            assert not torch.equal(a.sets[k][name], c.sets[k][name])
    assert torch.equal(a.buf, b.buf) and not torch.equal(a.buf, c.buf)


def stale(self, s):
    """The weight buffers rewritten once and never again."""
    if self.current is None:
        real_show(self, s)


def one_set(self, s):
    """Every step served with set 0."""
    if self.current is None:
        real_show(self, 0)
    self.current = s


real_show = plugins.load("traffic/kinds", "model-refresh").Inputs.show


@pytest.mark.parametrize("fault", [stale, one_set], ids=lambda f: f.__name__)
def test_stale_or_reused_weights_are_not_correct(fault, monkeypatch):
    kind = plugins.load("traffic/kinds", "model-refresh")
    monkeypatch.setattr(kind.Inputs, "show", fault)
    out = harness.run_cell(CELL, 77, 0.2, False, device=torch.device("cpu"),
                           t_start=time.perf_counter(),
                           overrides=SMALL[CELL])
    assert not out["correct"] and out["failed"] > 0
    check = out["checks"]["max_rel_err"]
    assert check["value"] > check["limit"]
