"""Traffic kind ``model-refresh``: the graph and the features stay
resident, and the weights change to the next of ``weight_sets`` seeded
Glorot sets before each inference: the mirror image of
``feature-refresh``.

One feature snapshot is drawn from the run's seed with the configuration's
feature density and column skew (the columns' profile is the dataset's,
from its ``graph_seed``), written once into the dense feature buffer, and
handed to the program as the same tensor object at every inference, so
the executor may keep its profile and walk format, as it may for the
resident graph.  Each weight is one buffer, rewritten in place to the
step's set before the inference and handed over as a new tensor object (a
fresh view), so every Update profiles and plans the new weights.  The
reference is handed the sets themselves, not the buffers.

Parameters of the mix: ``weight_sets`` (the steps), ``order`` (``cycle``:
0, 1, ..., weight_sets - 1, again and again).
"""
from typing import Dict, Tuple

import numpy as np
import torch

from bench.traffic import generator

ORDERS = ("cycle",)
PARAMETERS = ("weight_sets", "order")


def set_seed(seed: int, k: int) -> int:
    """The seed of weight set ``k`` of a run of seed ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(k)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Inputs:
    """The steps of one run: weight set ``s`` with the resident
    features."""

    # the features stay resident: the needed work counts their nonzeros
    RESIDENT_FEATURES = True

    def __init__(self, cell):
        """``cell``: the program (``programs/gnn.py``), whose
        configuration, traffic, seed, device, model and layer widths the
        inputs follow."""
        cfg, traffic = cell.cfg, cell.traffic
        missing = [k for k in PARAMETERS if k not in traffic]
        if missing:
            raise ValueError(f"model-refresh: the mix lacks {missing}")
        if traffic["order"] not in ORDERS:
            raise ValueError(f"model-refresh: unknown order "
                             f"{traffic['order']!r}; known: {ORDERS}")
        n, f = cfg["n_vertices"], cfg["f_in"]
        self.steps = int(traffic["weight_sets"])
        self.features = cfg["program"]["inputs"]["features"]
        col_p = generator.column_probabilities(f, cfg["feature_density"],
                                               cfg["graph_seed"])
        (self.snapshot,) = generator.feature_snapshots(n, col_p, 1,
                                                       cell.seed, cell.device)
        self.buf = torch.zeros((n, f), dtype=torch.float32,
                               device=cell.device)
        generator.write_snapshot(self.buf, None, self.snapshot)
        shapes = cell.model.weight_shapes(cell.dims)
        self.sets = [generator.glorot_weights(shapes, set_seed(cell.seed, k),
                                              cell.device)
                     for k in range(self.steps)]
        self.weights = {name: torch.empty_like(w)
                        for name, w in self.sets[0].items()}
        self.current = None

    def step(self, i: int) -> int:
        """The step of the ``i``-th inference of the run."""
        return i % self.steps

    def show(self, s: int) -> None:
        """Rewrite the weight buffers to set ``s``."""
        if self.current != s:
            for name, buf in self.weights.items():
                buf.copy_(self.sets[s][name])
            self.current = s

    def program_tensors(self, s: int) -> Dict[str, torch.Tensor]:
        """The program's inputs besides the adjacency at step ``s``: the
        features as the same tensor object, and the weights as fresh
        views."""
        self.show(s)
        return {self.features: self.buf,
                **{name: buf.view(buf.shape)
                   for name, buf in self.weights.items()}}

    def reference_inputs(self, s: int
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The features and weight set ``s``."""
        return self.buf, self.sets[s]

    def describe(self) -> str:
        return (f"feature nonzeros {int(self.snapshot[0].numel())}, "
                f"{self.steps} weight sets")
