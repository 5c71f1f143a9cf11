"""The float32 walk's held lhs format (``dispatch.WalkFormat``) and the
fused executor's rule for keeping one (``FusedModelExecutor._x_format``).

On the CPU the plain walk needs no format, so the rule runs with a stub
``dispatch.build_x_format`` and a spy on ``dispatch.block_matmul``
that records the format each walk was handed: the first run that reads a
graph input builds nothing, the next builds once and every later walk
reuses it; a fresh view, an in-place write, an inference tensor and an
intermediate lhs never get one; one entry per (name, k-block edge,
device), gone with the executor; and the counters keep the bytes a pass
in every walk would read.  The ``card`` tests run the CUDA route: held
formats bitwise the fresh ones and ``DynasparseEngine`` at unaligned
vertex counts, an in-place write to A, a format built while the walk's
skip flag is set, ``x_words_kernel`` only in builds, and a mismatched
format raising.

Imports neither jax nor the JAX package, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q tests/test_torch_walk_format.py``.
"""
import gc
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.kernels as K
from repro_torch import trace
from repro_torch.core import runtime
from repro_torch.kernels import dispatch
from repro_torch.models import gnn

# GCN walks H0 (its first Update) and A (both Aggregates) as lhs; SAGE
# walks A_mean (both Aggregates) and H0 (the first self Update)
HELD = {"gcn": ("A", "H0"), "sage": ("A_mean", "H0")}


def bundle(model, scale=0.05, device="cpu"):
    return gnn.build_dense(model, "CO", scale=scale, seed=2, device=device)


class Spy:
    """A stub format build and a walk spy: ``built`` holds the tensors a
    format was built for, ``walks`` one (x, id of its x_format or None)
    per walk (an id, so that the spy keeps no format alive)."""

    def __init__(self, monkeypatch, count=False):
        self.built, self.walks = [], []
        self.count = count
        plain = dispatch.block_matmul

        def build(x, K, bk):
            fmt = dispatch.WalkFormat(None, 0, 0, x.shape[0], x.shape[1], K,
                                      bk, x.device, x.data_ptr())
            if count:            # as build_x_format counts its pass
                dispatch.count_bitmask_pass(x, bk, 0)
                trace.count("walk_format_builds")
            self.built.append(x)
            return fmt

        def walk(x, y, codes, block, **kw):
            fmt = kw.get("x_format")
            self.walks.append((x, None if fmt is None else id(fmt)))
            if count:            # as the float32 route counts a walk
                dispatch.count_walk(x, block[1], fmt, 0)
            return plain(x, y, codes, block, **kw)

        monkeypatch.setattr(dispatch, "build_x_format", build)
        monkeypatch.setattr(dispatch, "block_matmul", walk)
        monkeypatch.setattr(runtime, "takes_x_format",
                            lambda x, y, strategy: strategy == "dynamic")

    def formats(self, since=0):
        return [f for _, f in self.walks[since:] if f is not None]


def run(ex, b, tensors=None):
    return ex.run(b.compiled, b.tensors if tensors is None else tensors)


@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_first_run_builds_nothing_then_builds_once_then_reuses(
        monkeypatch, model):
    b = bundle(model)
    spy = Spy(monkeypatch)
    ex = runtime.FusedModelExecutor(collect_report=False)
    run(ex, b)
    assert spy.built == [] and spy.formats() == []
    n = len(spy.walks)
    run(ex, b)
    held = [b.tensors[name] for name in HELD[model]]
    assert len(spy.built) == 2
    assert all(any(x is t for t in held) for x in spy.built)
    second = spy.formats(n)
    # every walk over a held input got its format, the builds' included
    assert len(second) == sum(any(x is t for t in held)
                              for x, _ in spy.walks[n:])
    run(ex, b)
    assert len(spy.built) == 2
    third = spy.formats(2 * n)
    assert third == second


@pytest.mark.parametrize("change", ["fresh_view", "in_place_write",
                                    "inference_tensor"])
def test_unsteady_inputs_get_no_format(monkeypatch, change):
    b = bundle("gcn")
    spy = Spy(monkeypatch)
    ex = runtime.FusedModelExecutor(collect_report=False)
    a = b.tensors["A"]
    if change == "inference_tensor":
        with torch.inference_mode():
            a = a.clone()
    for _ in range(4):
        if change == "fresh_view":
            a = b.tensors["A"].view(b.tensors["A"].shape)
        elif change == "in_place_write":
            a.mul_(1.0)             # bumps A's _version
        run(ex, b, dict(b.tensors, A=a))
    assert all(x is not a for x in spy.built)
    assert all(f is None for x, f in spy.walks if x is a)
    if change == "inference_tensor":
        assert not any(key[0] == "A" for key in ex._walk_formats)


def test_intermediates_never_get_a_format(monkeypatch):
    b = bundle("sage")
    spy = Spy(monkeypatch)
    ex = runtime.FusedModelExecutor(collect_report=False)
    for _ in range(3):
        run(ex, b)
    inputs = list(b.tensors.values())
    assert spy.formats()
    for x, f in spy.walks:
        if f is not None:
            assert any(x is t for t in inputs)
    assert {key[0] for key in ex._walk_formats} == set(HELD["sage"])


def test_in_place_write_reprofiles_the_input():
    """The input profiles follow the same rule: a write in place (a new
    ``_version``) is profiled again, so an edge in a block that was empty
    is planned, not SKIPped."""
    b = bundle("gcn", 0.06)
    a = b.tensors["A"]
    a[:64, 128:] = 0.0
    ex = runtime.FusedModelExecutor(collect_report=False)
    run(ex, b)
    a[5, 150] = 1.0
    want = run(runtime.FusedModelExecutor(collect_report=False), b)[0]
    got = run(ex, b)[0]
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_one_entry_per_key_and_a_new_object_drops_the_format(monkeypatch):
    b = bundle("gcn")
    Spy(monkeypatch)
    ex = runtime.FusedModelExecutor(collect_report=False)
    run(ex, b)
    run(ex, b)
    keys = set(ex._walk_formats)
    assert len(keys) == 2 and {k[0] for k in keys} == set(HELD["gcn"])
    old = weakref.ref(ex._walk_formats[("A", keys.pop()[1], torch.device(
        "cpu"))][3])
    assert old() is not None
    for _ in range(3):
        run(ex, b, dict(b.tensors, A=b.tensors["A"].clone()))
        assert len(ex._walk_formats) == 2
    gc.collect()
    assert old() is None


def test_formats_die_with_the_executor(monkeypatch):
    b = bundle("sage")
    Spy(monkeypatch)
    ex = runtime.FusedModelExecutor(collect_report=False)
    for _ in range(3):
        run(ex, b)
    refs = [weakref.ref(v[3]) for v in ex._walk_formats.values()]
    assert refs and all(r() is not None for r in refs)
    del ex
    gc.collect()
    assert all(r() is None for r in refs)


def test_wave_walks_hold_no_format(monkeypatch):
    b = bundle("gcn")
    spy = Spy(monkeypatch)
    ex = runtime.FusedModelExecutor(collect_report=False)
    batched = {"H0": torch.stack([b.tensors["H0"]] * 2)}
    shared = {k: v for k, v in b.tensors.items() if k != "H0"}
    for _ in range(3):
        ex.run_batch(b.compiled, shared, batched)
    assert spy.built == [] and spy.formats() == []
    assert ex._walk_formats == {}


@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_counted_bytes_add_up_to_a_pass_in_every_walk(monkeypatch, model):
    """``bitmask_bytes`` + ``bitmask_reused_bytes`` over runs equals the
    bytes of a pass in every walk (what the walk counted before formats
    were held); each build counts one pass, each later walk one hit."""
    b = bundle(model)
    spy = Spy(monkeypatch, count=True)
    ex = runtime.FusedModelExecutor(collect_report=False)
    K.reset_launch_counts()
    runs = 4
    for _ in range(runs):
        run(ex, b)
    c = trace.counters()
    every_walk = sum(x.numel() * x.element_size() for x, _ in spy.walks)
    assert c["bitmask_bytes"] + c["bitmask_reused_bytes"] == every_walk
    assert c["walk_format_builds"] == len(spy.built) == 2
    held = [f for _, f in spy.walks if f is not None]
    assert c["walk_format_hits"] == len(held) - 2
    assert c["bitmask_reused_bytes"] == sum(
        x.numel() * x.element_size() for x, f in spy.walks
        if f is not None) - sum(x.numel() * x.element_size()
                                for x in spy.built)


def test_format_rejects_another_operand():
    x = torch.zeros(20, 40)
    fmt = dispatch.WalkFormat(None, 0, 0, 20, 40, 3, 16, x.device,
                              x.data_ptr())
    fmt.check(x, 3, 16)
    for args in ((x.clone(), 3, 16), (x, 2, 16), (x, 3, 32),
                 (x[:10], 3, 16)):
        with pytest.raises(ValueError, match="x_format"):
            fmt.check(*args)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("model", ["gcn", "sage"])
@pytest.mark.parametrize("scale", [0.05, 0.06])     # n % 4 == 3, 2
def test_card_held_format_bitwise(cuda, model, scale):
    b = bundle(model, scale, device=cuda)
    assert b.tensors["H0"].shape[0] % 4 in (2, 3)
    ex = runtime.FusedModelExecutor(collect_report=False,
                                    keep_intermediates=True)
    K.reset_launch_counts()
    outs = [run(ex, b)[0] for _ in range(3)]
    c = trace.counters()
    assert c["walk_format_builds"] == 2
    assert c["walk_format_hits"] >= 2 and c["bitmask_reused_bytes"] > 0
    want, _ = runtime.DynasparseEngine().run(b.compiled, b.tensors)
    for name in outs[0]:
        for out in outs[1:] + [want]:
            assert torch.equal(outs[0][name], out[name]), name


@pytest.mark.card
def test_card_in_place_write_gives_the_new_answer(cuda):
    b = bundle("gcn", 0.06, device=cuda)
    ex = runtime.FusedModelExecutor(collect_report=False)
    for _ in range(3):
        run(ex, b)
    a = b.tensors["A"]
    n = a.shape[0]
    # edges into tiles that held none, so a stale bitmask would drop them
    a[0, n - 1] = 0.5
    a[n - 1, 17] = 0.25
    a[n // 2, :] = 0.0
    fresh = runtime.FusedModelExecutor(collect_report=False)
    want = run(fresh, b)[0]
    for _ in range(3):            # first sight again, a build, a hit
        got = run(ex, b)[0]
        for name in want:
            assert torch.equal(got[name], want[name]), name


@pytest.mark.card
def test_card_format_built_under_skip_serves_the_next_walk(cuda):
    g = torch.Generator(device="cpu").manual_seed(3)
    x = (torch.rand(162, 143, generator=g) < 0.05).float().to(cuda)
    y = torch.randn(143, 30, generator=g).to(cuda)
    block = (64, 64, 64)
    codes = torch.ones((3, 1, 3), dtype=torch.int32, device=cuda)
    fmt = dispatch.build_x_format(x, 3, 64)
    skip = torch.ones((), dtype=torch.int32, device=cuda)
    buf = torch.zeros((192, 64), device=cuda)
    dispatch.block_matmul(x, y, codes, block, out=buf, skip=skip,
                          x_format=fmt)
    assert not buf.any()          # the walk was skipped, the build was not
    want = dispatch.block_matmul(x, y, codes, block)
    got = dispatch.block_matmul(x, y, codes, block, x_format=fmt)
    assert torch.equal(got, want)


@pytest.mark.card
def test_card_x_words_only_in_builds(cuda):
    b = bundle("sage", 0.06, device=cuda)
    ex = runtime.FusedModelExecutor(collect_report=False)

    def x_words_launches():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(ex, b)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if "x_words_kernel" in e.key)

    walks = len(b.compiled.graph.topo_order())
    first = x_words_launches()
    K.reset_launch_counts()
    second = x_words_launches()
    builds = trace.counters()["walk_format_builds"]
    third = x_words_launches()
    assert first == walks and builds == 2
    # the builds' passes over A_mean and H0; the second Aggregate's walk
    # reuses A_mean's
    assert second == walks - 1
    # A_mean twice and H0 once come from held formats
    assert third == walks - 3


@pytest.mark.card
def test_card_mismatched_format_raises(cuda):
    x = torch.rand(100, 70, device=cuda)
    y = torch.rand(70, 20, device=cuda)
    codes = torch.ones((2, 1, 2), dtype=torch.int32, device=cuda)
    fmt = dispatch.build_x_format(x, 2, 64)
    for other, cd, block in ((x.clone(), codes, (64, 64, 64)),
                             (x, codes, (64, 48, 64))):
        with pytest.raises(ValueError, match="x_format"):
            dispatch.block_matmul(other, y, cd, block, x_format=fmt)
    with pytest.raises(ValueError, match="float32 walk"):
        dispatch.block_matmul(x.bfloat16(), y.bfloat16(), codes,
                              (64, 64, 64), x_format=fmt)
