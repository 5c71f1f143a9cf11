"""Traffic kind ``feature-refresh``: the graph and the weights stay
resident, and the dense features change to the next of ``snapshots``
feature snapshots before each inference.

The snapshots are drawn from the run's seed with the configuration's
feature density and column skew (the columns' profile is the dataset's,
from its ``graph_seed``), the Glorot weights from the run's seed, all on
the card.  One feature buffer is rewritten in place between inferences
and handed to the program as a new tensor object (a fresh view), so the
executor's identity-keyed profile cache profiles the features again, as
it must for new data, and keeps the adjacency's profile, as it may for a
resident graph.

Parameters of the mix: ``snapshots`` (the steps), ``order`` (``cycle``:
0, 1, ..., snapshots - 1, again and again).
"""
from typing import Dict, Tuple

import torch

from bench.traffic import generator

ORDERS = ("cycle",)


class Inputs:
    """The steps of one run: feature snapshot ``s`` with the resident
    weights."""

    # the features change at every step: the needed work reads them whole
    RESIDENT_FEATURES = False

    def __init__(self, cell):
        """``cell``: the program (``programs/gnn.py``), whose
        configuration, traffic, seed, device, model and layer widths the
        inputs follow."""
        cfg, traffic = cell.cfg, cell.traffic
        if traffic["order"] not in ORDERS:
            raise ValueError(f"feature-refresh: unknown order "
                             f"{traffic['order']!r}; known: {ORDERS}")
        n, f = cfg["n_vertices"], cfg["f_in"]
        self.steps = int(traffic["snapshots"])
        self.features = cfg["program"]["inputs"]["features"]
        col_p = generator.column_probabilities(f, cfg["feature_density"],
                                               cfg["graph_seed"])
        self.snapshots = generator.feature_snapshots(
            n, col_p, self.steps, cell.seed, cell.device)
        self.weights = generator.glorot_weights(
            cell.model.weight_shapes(cell.dims), cell.seed, cell.device)
        self.buf = torch.zeros((n, f), dtype=torch.float32,
                               device=cell.device)
        self.current = None

    def step(self, i: int) -> int:
        """The step of the ``i``-th inference of the run."""
        return i % self.steps

    def show(self, s: int) -> None:
        """Rewrite the feature buffer to snapshot ``s``."""
        if self.current != s:
            prev = (None if self.current is None
                    else self.snapshots[self.current])
            generator.write_snapshot(self.buf, prev, self.snapshots[s])
            self.current = s

    def program_tensors(self, s: int) -> Dict[str, torch.Tensor]:
        """The program's inputs besides the adjacency at step ``s``: the
        features as a fresh tensor object, and the weights."""
        self.show(s)
        return {self.features: self.buf.view(self.buf.shape),
                **self.weights}

    def reference_inputs(self, s: int
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The features and the weights of step ``s``."""
        self.show(s)
        return self.buf, self.weights

    def describe(self) -> str:
        return (f"snapshot nonzeros "
                f"{[int(i.numel()) for i, _ in self.snapshots]}")
