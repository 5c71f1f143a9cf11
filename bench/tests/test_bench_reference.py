"""The plain reference against the program on the CPU at a small size, and
the control (the reference with TF32) failing the cell's limit."""
import pytest
import torch

from bench import harness
from bench.reference import check, gnn
from conftest import SMALL


@pytest.fixture(scope="module", params=sorted(SMALL))
def readings(request):
    """Per snapshot: the program's logits through the timed path, the
    reference's and the control's; one small cell each."""
    cell = request.param
    c = harness.Cell(harness.cell_spec(cell, SMALL[cell]), 21,
                     torch.device("cpu"))
    outs = [c.infer(s) for s in range(c.inputs.steps)]
    c.free_program()
    refs = [c.reference(s) for s in range(len(outs))]
    ctrl = [c.reference(s, "tf32") for s in range(len(outs))]
    return cell, outs, refs, ctrl


def test_the_program_agrees_with_the_reference(readings):
    cell, outs, refs, _ = readings
    limit = harness.load(harness.BENCH / "workloads"
                         / f"{cell}.json")["limits"]["max_rel_err"]
    errs = [check.max_rel_err(o, r) for o, r in zip(outs, refs)]
    assert max(errs) < limit / 10, errs


def test_the_control_fails_the_limit(readings):
    cell, _, refs, ctrl = readings
    limit = harness.load(harness.BENCH / "workloads"
                         / f"{cell}.json")["limits"]["max_rel_err"]
    errs = [check.max_rel_err(o, r) for o, r in zip(ctrl, refs)]
    assert min(errs) > 3 * limit, errs


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -9, 0.0])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0, -3.0 - 2 ** -9, 0.0])
    assert torch.equal(gnn.tf32_round(x), want)
    assert torch.equal(gnn.tf32_round(torch.tensor([1.0 + 3 * 2 ** -11])),
                       torch.tensor([1.0 + 2 ** -9]))      # ties to even


def test_check_reads_infinity_for_a_wrong_answer():
    ref = torch.ones((4, 3))
    assert check.max_rel_err(ref.clone(), ref) == 0.0
    assert check.max_rel_err(None, ref) == float("inf")
    assert check.max_rel_err(torch.ones((3, 3)), ref) == float("inf")
    bad = ref.clone()
    bad[1, 1] = float("nan")
    assert check.max_rel_err(bad, ref) == float("inf")
