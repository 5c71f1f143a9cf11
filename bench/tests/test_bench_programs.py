"""The harness reaches a cell's program through the family its
configuration names (``programs/<family>.py``): a stand-in family with no
graph runs through it, the ``gnn`` family reads what the harness read
before the family moved out of it, and an unknown family or model setting
is refused."""
import hashlib
import statistics
import time
from pathlib import Path

import pytest
import torch

from bench import harness, plugins
from bench import trace as tracing
from bench.reference import check, gnn, work
from bench.traffic import generator
from conftest import SMALL

HARNESS = Path(harness.__file__)

# Recorded from the harness before the ``gnn`` family moved out of it, at
# the tests' sizes: per cell and seed, the SHA-256 (first 16 hex digits)
# of the adjacency, of the features at each step and of each weight
# (``inputs``), and the (flops, bytes) of each step's needed work.
PARENT = {
    ("gcn-nell.feature-refresh", 21): {
        "inputs": ["fea347a3e54a52ef", "233b4bf8c30fa8dd", "8ef3bdc9925b2464",
                   "7fa4a8bdf8bc6761", "d65c1a36fe0210f6", "2c0866d742b41a59",
                   "1f56199ef9598659", "59642af0f097418f", "dc6430fb58594cf4",
                   "8b3a4dff55166ce0", "a1170aff35545482"],
        "work": [[1240232, 2708560], [1215584, 2708560], [1225040, 2708560],
                 [1234032, 2708560], [1229512, 2708560], [1228576, 2708560],
                 [1238024, 2708560], [1229256, 2708560]]},
    ("gcn-nell.feature-refresh", 2 ** 31 + 7): {
        "inputs": ["fea347a3e54a52ef", "d55270bc2491c615", "0dc786d01835320a",
                   "a46c36e2c3a0e4d8", "14bb8ca5d3930557", "6700b7b453819a56",
                   "4c990cac742c04fe", "c09d6d9738a64968", "d6459db31f463f6a",
                   "b1b2295222d99ac1", "94e47388c9b04c86"],
        "work": [[1249016, 2708560], [1241168, 2708560], [1255912, 2708560],
                 [1258336, 2708560], [1245824, 2708560], [1259024, 2708560],
                 [1260600, 2708560], [1265096, 2708560]]},
    ("sage-flickr.feature-refresh", 21): {
        "inputs": ["e8a489fd7adff423", "01da924f51937a13", "5a92037b5cb3effa",
                   "3d718f89c9ca0879", "90d2534005d11496", "d10fb0f9a48fb741",
                   "1061e5df78dc7ab4", "44390282c36c2143", "540547785ff08a26",
                   "b708da1e80919ae1", "6a7fa63bc1c435c6", "8dcbca1f8c8b2102",
                   "00b75fe919efd036"],
        "work": [[4642020, 363712], [4688340, 363712], [4639692, 363712],
                 [4669864, 363712], [4647520, 363712], [4672648, 363712],
                 [4656744, 363712], [4672376, 363712]]},
    ("sage-flickr.feature-refresh", 2 ** 31 + 7): {
        "inputs": ["e8a489fd7adff423", "e551964a3f64254f", "d4f31d6aac7dc3b7",
                   "f20cab50232c7bcf", "2903beed0b7ffffc", "352272cd9d78e7e3",
                   "63c6d485b5426ea2", "829e56e31387c1e4", "cc410af7fb361c8f",
                   "b6f97463cb0e293a", "1ea125bb17409dc2", "28686e713042723d",
                   "bb6ffa44c9389e22"],
        "work": [[4638968, 363712], [4656788, 363712], [4652368, 363712],
                 [4629252, 363712], [4640120, 363712], [4651948, 363712],
                 [4651156, 363712], [4633360, 363712]]},
}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


class ParentCell:
    """The harness's ``Cell`` and ``step_work`` as they were before the
    ``gnn`` family moved out of it, copied whole: the yardstick the
    family is held to."""

    def __init__(self, spec: dict, seed: int, device: torch.device):
        cfg, traffic = spec["config"], spec["traffic"]
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = seed, device
        self.model_name = cfg["model"]
        self.model = gnn.model(cfg["model"])
        self.loop = plugins.load("traffic/loops", traffic["loop"])
        kind = plugins.load("traffic/kinds", traffic["kind"])
        n = cfg["n_vertices"]
        self.dims = [cfg["f_in"]] + [cfg["hidden"]] * (cfg["n_layers"] - 1) \
            + [cfg["n_classes"]]
        rows, cols = generator.edge_list(n, cfg["n_edges"],
                                         cfg["graph_seed"],
                                         **cfg["generator"])
        self.nnz_adj = int(rows.shape[0])
        self.adj = generator.dense_adjacency(
            rows, cols, self.model.normalize(rows, cols, n), n, device)
        self.inputs = kind.Inputs(self)
        self._program()

    def _program(self) -> None:
        from repro_torch.core import compiler, runtime
        from repro_torch.models import gnn as program_gnn
        cfg, prog = self.cfg, self.cfg["program"]
        spec = program_gnn.make_model_spec(self.model_name, cfg["f_in"],
                                           cfg["hidden"], cfg["n_classes"])
        meta = compiler.GraphMeta(cfg["name"], cfg["n_vertices"],
                                  cfg["n_edges"], cfg["f_in"])
        self.compiled = compiler.compile_model(
            spec, meta, n_cc=prog["n_cc"], align=prog["align"],
            on_chip_bytes=prog["on_chip_bytes"])
        self.executor = runtime.FusedModelExecutor(
            strategy=prog["strategy"], collect_report=False)
        self.adj_name = prog["inputs"]["adjacency"]
        self.final = self.compiled.graph.kernels[-1].out

    def infer(self, s: int) -> torch.Tensor:
        tensors = {self.adj_name: self.adj,
                   **self.inputs.program_tensors(s)}
        env, _ = self.executor.run(self.compiled, tensors)
        return env[self.final]

    def free_program(self) -> None:
        self.executor = self.compiled = None

    def reference(self, s: int, precision: str = "float32"):
        x, weights = self.inputs.reference_inputs(s)
        return gnn.forward(self.model_name, self.adj, x, weights,
                           precision=precision)

    def step_work(self):
        adj_col = work.colnnz(self.adj)
        out = []
        for s in range(self.inputs.steps):
            x, weights = self.inputs.reference_inputs(s)
            hs = gnn.forward(self.model_name, self.adj, x, weights)
            out.append(work.inference_work(self.model_name, self.adj,
                                           adj_col, x, weights, hs))
            del hs
        return out


def readings(cell_of, adj_of, steps_of):
    """Inputs' digests (the adjacency, the features handed to the program
    at each step, each weight), outputs, errors and work of one cell."""
    c = cell_of()
    steps = c.inputs.steps
    ins = [digest(adj_of(c))]
    for s in range(steps):
        ins.append(digest(c.inputs.program_tensors(s)[c.inputs.features]))
    ins += [digest(w) for w in c.inputs.weights.values()]
    outs = [c.infer(s) for s in range(steps)]
    c.free_program()
    refs, work_ = steps_of(c)
    errs = [check.max_rel_err(o, r) for o, r in zip(outs, refs)]
    return ins, outs, errs, work_


@pytest.mark.parametrize("seed", [21, 2 ** 31 + 7])
@pytest.mark.parametrize("cell", ["gcn-nell.feature-refresh",
                                  "sage-flickr.feature-refresh"])
def test_the_gnn_family_reads_what_the_harness_read(cell, seed):
    """Inputs bit for bit, outputs and ``max_rel_err`` to the last bit,
    and the needed work equal to the harness's before the move (a copy of
    its ``Cell`` in this process, and counts recorded from it)."""
    spec = harness.cell_spec(cell, SMALL[cell])
    cpu = torch.device("cpu")
    new = readings(
        lambda: harness.Cell(spec, seed, cpu), lambda c: c.program.adj,
        lambda c: ([c.reference(s) for s in range(c.inputs.steps)],
                   [c.program.work(s) for s in range(c.inputs.steps)]))
    old = readings(
        lambda: ParentCell(spec, seed, cpu), lambda c: c.adj,
        lambda c: ([c.reference(s)[-1] for s in range(c.inputs.steps)],
                   c.step_work()))
    assert new[0] == old[0] == PARENT[(cell, seed)]["inputs"]
    assert all(torch.equal(a, b) for a, b in zip(new[1], old[1]))
    assert new[2] == old[2]
    assert [[w["flops"], w["bytes"]] for w in new[3]] \
        == [[w["flops"], w["bytes"]] for w in old[3]] \
        == PARENT[(cell, seed)]["work"]
    assert {w["precision"] for w in new[3]} == {"float32"}


def test_the_harness_names_no_gnn():
    """The harness holds no code of one family: no graph draw, no model
    spec, no executor, no GNN reference."""
    src = HARNESS.read_text()
    for name in ("make_model_spec", "FusedModelExecutor", "gnn", "edge_list",
                 "dense_adjacency", "graph", "adjacency"):
        assert name not in src, name


def test_an_unknown_program_family_is_refused():
    cell = "gcn-nell.feature-refresh"
    spec = harness.cell_spec(cell, {**SMALL[cell], "family": "no-such"})
    with pytest.raises(LookupError):
        harness.Cell(spec, 1, torch.device("cpu"))


def test_an_unknown_model_setting_is_refused():
    cell = "gcn-nell.feature-refresh"
    spec = harness.cell_spec(cell, {**SMALL[cell],
                                    "model_spec": {"no_such_setting": 1}})
    with pytest.raises(LookupError):
        harness.Cell(spec, 1, torch.device("cpu"))


@pytest.mark.parametrize("derived", ["model", "layer_dims"])
def test_a_setting_the_configuration_gives_elsewhere_is_refused(derived):
    cell = "gcn-nell.feature-refresh"
    spec = harness.cell_spec(cell, {**SMALL[cell],
                                    "model_spec": {derived: "gat"}})
    with pytest.raises(LookupError):
        harness.Cell(spec, 1, torch.device("cpu"))


def test_a_model_setting_reaches_the_program(monkeypatch):
    """``model_spec`` replaces the spec's settings, enums from their
    names; a configuration that states none compiles the spec
    ``make_model_spec`` gives."""
    from repro_torch.core import compiler
    from repro_torch.core.ir import Activation
    from repro_torch.models import gnn as program_gnn
    seen = []
    real = compiler.compile_model

    def spy(spec, meta, **kw):
        seen.append(spec)
        return real(spec, meta, **kw)
    monkeypatch.setattr(compiler, "compile_model", spy)
    cell = "gcn-nell.feature-refresh"
    cfg = harness.cell_spec(cell, SMALL[cell])["config"]
    harness.Cell(harness.cell_spec(cell, SMALL[cell]), 1, torch.device("cpu"))
    harness.Cell(harness.cell_spec(cell, {
        **SMALL[cell], "model_spec": {"gat_heads": 4, "att_threshold": 0.0,
                                      "activation": seen[0].activation.value}
    }), 1, torch.device("cpu"))
    plain = program_gnn.make_model_spec("gcn", cfg["f_in"], cfg["hidden"],
                                        cfg["n_classes"])
    assert seen[0] == plain
    assert (seen[1].gat_heads, seen[1].att_threshold) == (4, 0.0)
    assert isinstance(seen[1].activation, Activation)
    assert seen[1].layer_dims == plain.layer_dims


# --- a stand-in family: token ids in, logits out, bf16, no graph ---------

class TokenInputs:
    """Token ids of ``steps`` batches, drawn from the seed."""

    def __init__(self, traffic, seed, vocab):
        g = torch.Generator().manual_seed(seed)
        self.steps = traffic["batches"]
        self.ids = [torch.randint(vocab, (traffic["batch"], traffic["tokens"]),
                                  generator=g) for _ in range(self.steps)]

    def step(self, i):
        return i % self.steps

    def show(self, s):
        pass

    def describe(self):
        return f"{self.steps} token batches"


class TokenProgram:
    """An embedding and an output head in bf16: logits of each token."""

    def __init__(self, cfg, traffic, seed, device):
        g = torch.Generator().manual_seed(seed + 1)
        v, d = cfg["vocab"], cfg["width"]
        self.emb = torch.randn((v, d), generator=g).to(torch.bfloat16)
        self.head = (torch.randn((d, v), generator=g) / d ** 0.5
                     ).to(torch.bfloat16)
        self.inputs = TokenInputs(traffic, seed, v)
        self.held = (self.emb, self.head)

    def infer(self, s):
        emb, head = self.held
        return emb[self.inputs.ids[s]] @ head

    def free_program(self):
        self.held = None

    def reference(self, s, precision="float32"):
        return self.emb.float()[self.inputs.ids[s]] @ self.head.float()

    def work(self, s):
        (b, t), (d, v) = self.inputs.ids[s].shape, self.head.shape
        return {"flops": 2.0 * b * t * d * v,
                "bytes": 2.0 * (b * t * d + d * v + b * t * v),
                "precision": "bfloat16"}

    def describe(self):
        return self.inputs.describe()


STANDIN = type("Family", (), {"Program": TokenProgram})
STANDIN_SPEC = {
    "cell": "stand-in.tokens",
    "workload": {"config": "stand-in", "traffic": "tokens",
                 "limits": {"max_rel_err": 2e-2}},
    "config": {"name": "stand-in", "family": "stand-in", "vocab": 512,
               "width": 64},
    "traffic": {"loop": "closed", "clients": 1, "batches": 3, "batch": 4,
                "tokens": 32, "warmup_inferences": 2},
}


def test_a_family_with_no_graph_runs_through_the_harness(monkeypatch):
    """The stand-in family runs through ``run_cell``: the closed loop, the
    check, and ``mfu`` and ``kernels_roofline`` against the bf16 peak."""
    real_load = plugins.load
    monkeypatch.setattr(plugins, "load", lambda folder, name: (
        STANDIN if (folder, name) == ("programs", "stand-in")
        else real_load(folder, name)))
    monkeypatch.setattr(harness, "cell_spec",
                        lambda cell, overrides=None: STANDIN_SPEC)
    h100 = work.peaks("NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(harness, "device_peaks", lambda device, name: h100)
    busy = 0.002

    def profile(fn, calls, device):
        fn()
        return {"complete": True, "windows": 1, "calls": calls,
                "window_s": 2 * busy, "busy_s": busy, "events": [],
                "dtoh": 0, "breakdown": {"device_ops": [], "idle_gaps": []}}
    monkeypatch.setattr(tracing, "profile_window", profile)
    ctxs = []
    real_reader = harness.reader

    def reader(name):
        read = real_reader(name)

        def spy(ctx):
            ctxs.append(ctx)
            return read(ctx)
        return spy
    monkeypatch.setattr(harness, "reader", reader)

    out = harness.run_cell("stand-in.tokens", 9, 0.2, True,
                           device=torch.device("cpu"),
                           t_start=time.perf_counter())
    assert out["correct"] and out["failed"] == 0
    assert 0 < out["checks"]["max_rel_err"]["value"] < 2e-2
    ctx = ctxs[0]
    lat, seen = ctx["latencies_s"], ctx["per_step"]
    flops = [w["flops"] for w in ctx["work"]]
    mean_flops = sum(f * k for f, k in zip(flops, seen)) / sum(seen)
    assert out["metrics"]["mfu"]["value"] == pytest.approx(
        100 * mean_flops / (statistics.fmean(lat) * 989e12), rel=1e-12)
    bound = statistics.fmean(max(w["flops"] / 989e12,
                                 w["bytes"] / 3.35e12) for w in ctx["work"])
    assert out["metrics"]["kernels_roofline"]["value"] == pytest.approx(
        100 * bound / (busy / 3), rel=1e-12)


def test_a_family_whose_steps_mix_precisions_is_refused():
    ctx = {"work": [{"flops": 1.0, "bytes": 1.0, "precision": "float32"},
                    {"flops": 1.0, "bytes": 1.0, "precision": "bfloat16"}],
           "peaks": work.peaks("NVIDIA H100 80GB HBM3"),
           "latencies_s": [1.0, 1.0], "per_step": [1, 1]}
    with pytest.raises(ValueError):
        harness.reader("mfu")(ctx)
