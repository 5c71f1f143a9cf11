"""The plain reference of the benchmark's GNNs: dense ``torch`` products in
float32 with TF32 off, no kernels, no planning, no caches.

Each model is a file of its own, ``models/<model>.py``, found by the name
that its configuration gives: its adjacency normalization
(``normalize``), its weights (``weight_shapes``), its layers
(``forward``) and the work they need (``needed_macs``, for
``work.py``).  It imports nothing of the program: it is handed the same
adjacency, features and weights that the program receives, and works out
everything else itself.

``precision="tf32"`` is the control of the correctness check: the same
products with TF32 on (on the CPU, which has no TF32, the operands of
each product are rounded to TF32's 10-bit mantissa first).
"""
from __future__ import annotations

import contextlib
from types import ModuleType
from typing import Dict, List, Tuple

import torch

from bench import plugins

MODELS = plugins.names("reference/models")


def model(name: str) -> ModuleType:
    """``models/<name>.py``; an unknown model raises."""
    return plugins.load("reference/models", name)


def weight_shapes(name: str, dims: List[int]) -> Dict[str, Tuple[int, int]]:
    """The weights of model ``name`` with layer widths ``dims`` ([f_in,
    hidden, ..., n_classes]), in the order they are drawn."""
    return model(name).weight_shapes(dims)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest even at TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    keep = ((bits >> 13) & 1) + 0xFFF
    return ((bits + keep) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision_of(precision: str, device: torch.device):
    """TF32 off for ``float32``, on for ``tf32``, restored after."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    if device.type != "cuda":
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@torch.no_grad()
def forward(name: str, adj: torch.Tensor, x: torch.Tensor,
            weights: Dict[str, torch.Tensor], *,
            precision: str = "float32") -> List[torch.Tensor]:
    """Every layer's output ``[H_1, ..., H_L]`` (the last is the logits) of
    model ``name`` on the dense normalized adjacency ``adj`` and the dense
    features ``x``."""
    def mm(a, b):
        if precision == "tf32" and a.device.type != "cuda":
            a, b = tf32_round(a), tf32_round(b)
        return a @ b
    with precision_of(precision, adj.device):
        return model(name).forward(adj, x, weights, mm)
