"""Program family ``gnn``: full-graph GNN inference through
``repro_torch``'s ``FusedModelExecutor(strategy=...,
collect_report=False).run(compiled, tensors)``.

The resident graph is the configuration's, drawn from its ``graph_seed``
(a resident graph is one dataset) and built dense on the device; the
traffic kind (``traffic/kinds/<kind>.py``) draws the features and weights
of each step from the run's seed.  The model's plain reference is
``reference/models/<model>.py`` (through ``reference/gnn.py``), and the
work each step needs is ``reference/work.py``'s count.

The configuration may state ``model_spec``: settings of the program's
``GNNModelSpec`` (e.g. ``gat_heads``, ``att_threshold``) that replace
those of ``make_model_spec``; a setting the spec does not have raises.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict

import torch

from bench import plugins
from bench.reference import gnn, work
from bench.traffic import generator

# settings that come from the configuration's own keys, not ``model_spec``
DERIVED = ("model", "layer_dims")


def model_settings(cfg: dict) -> Dict[str, object]:
    """The configuration's ``model_spec``, each value in the type of the
    spec's field; an unknown or derived setting raises."""
    from repro_torch.core import compiler
    fields = {f.name: f for f in dataclasses.fields(compiler.GNNModelSpec)}
    out = {}
    for key, value in cfg.get("model_spec", {}).items():
        if key not in fields or key in DERIVED:
            raise LookupError(
                f"unknown model setting {key!r} of {cfg['name']}: "
                f"GNNModelSpec takes "
                f"{sorted(set(fields) - set(DERIVED))}")
        default = fields[key].default
        out[key] = (type(default)(value) if isinstance(default, enum.Enum)
                    else value)
    return out


class Program:
    """One run's resident graph, its traffic's inputs (``inputs``, of the
    mix's kind), and the compiled model with its executor."""

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = seed, device
        self.settings = model_settings(cfg)
        self.model_name = cfg["model"]
        self.model = gnn.model(cfg["model"])
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
        self._compile()
        self._adj_colnnz = None

    def _compile(self) -> None:
        from repro_torch.core import compiler, runtime
        from repro_torch.models import gnn as program_gnn
        cfg, prog = self.cfg, self.cfg["program"]
        spec = program_gnn.make_model_spec(self.model_name, cfg["f_in"],
                                           cfg["hidden"], cfg["n_classes"])
        spec = dataclasses.replace(spec, **self.settings)
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
        """One inference of the program at step ``s``; returns the
        logits."""
        tensors = {self.adj_name: self.adj,
                   **self.inputs.program_tensors(s)}
        env, _ = self.executor.run(self.compiled, tensors)
        return env[self.final]

    def free_program(self) -> None:
        """Drop the compiled model and the executor with its held state;
        the inputs stay."""
        self.executor = self.compiled = None

    def reference(self, s: int, precision: str = "float32") -> torch.Tensor:
        """The plain reference's logits at step ``s``."""
        x, weights = self.inputs.reference_inputs(s)
        return gnn.forward(self.model_name, self.adj, x, weights,
                           precision=precision)[-1]

    def work(self, s: int) -> dict:
        """The operations and bytes the inference at step ``s`` needs, in
        the configuration's precision; features that stay resident
        (``inputs.RESIDENT_FEATURES``) count their nonzeros, as the
        adjacency does."""
        if self._adj_colnnz is None:
            self._adj_colnnz = work.colnnz(self.adj)
        x, weights = self.inputs.reference_inputs(s)
        hs = gnn.forward(self.model_name, self.adj, x, weights)
        out = work.inference_work(self.model_name, self.adj,
                                  self._adj_colnnz, x, weights, hs,
                                  x_resident=self.inputs.RESIDENT_FEATURES)
        return {**out, "precision": self.cfg["dtype"]}

    def describe(self) -> str:
        return (f"adjacency nonzeros {self.nnz_adj}, "
                f"{self.inputs.describe()}")
