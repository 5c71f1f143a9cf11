"""AdamW + schedule + gradient utilities.

Port of ``repro.train.optimizer``.  The optimizer state mirrors the param
tree leaf for leaf (``train/tree.py``).  ``state_dtype`` keeps m/v in
float32, bfloat16 (the 100B+ archs; the update arithmetic then runs in
bfloat16 too) or ``"int8"`` (blockwise-quantized moments, one float32
scale per last-dim row, the arithmetic in bfloat16).

Two departures from the reference, neither changing a value:

* Weight decay.  The reference decays a leaf when ``p.ndim >= 2``
  (``src/repro/train/optimizer.py:107``) in ITS layout: under
  ``scan_layers=True`` every leaf of ``stack``/``enc_stack``/``dec_stack``
  has a leading layer axis, so the per-layer norm scales and biases are
  decayed there and not in ``dense_first`` or at the top level.  The port
  keeps one dict per layer, so :meth:`AdamW.update` takes that decision
  from a per-leaf mask (``model_zoo.decay_mask(cfg)``); without one it
  applies the reference's rule to the port's own shapes.
* ``upd_stacked``, the reference's per-layer ``fori_loop`` over a stacked
  leaf, bounds its update temporaries to one layer.  The port's
  per-layer layout has that effect already, so it is not ported.

:meth:`AdamW.update` is functional, as the reference's is: it returns new
tensors and leaves its inputs untouched.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.train import tree as tree_lib


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any
    v: Any


class Quantized(NamedTuple):
    """Blockwise int8-quantized optimizer moment (8-bit Adam state).

    q: int8 values; s: float32 per-last-dim-row scales (shape[..., 1])."""

    q: torch.Tensor
    s: torch.Tensor


def _c(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """A Python scalar as a 0-d tensor of ``dtype``: JAX rounds a weakly
    typed scalar to the array's type before the operation, where PyTorch
    would compute with it in float32."""
    return torch.tensor(value, dtype=dtype, device=device)


def _quantize(x: torch.Tensor) -> Quantized:
    s = (x.abs().amax(dim=-1, keepdim=True) / _c(127.0, x.dtype, x.device)
         + _c(1e-12, x.dtype, x.device))
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return Quantized(q, s.float())


def _dequantize(z: Quantized, dtype=torch.float32) -> torch.Tensor:
    return (z.q.float() * z.s).to(dtype)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        leaves = tree_lib.flatten(params)[0]
        dev = leaves[0].device if leaves else None
        if self.state_dtype == "int8":
            def zeros(p):
                return Quantized(
                    torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                    torch.full(p.shape[:-1] + (1,) if p.ndim else (1,),
                               1e-12, dtype=torch.float32, device=p.device))
        else:
            dt = getattr(torch, self.state_dtype)

            def zeros(p):
                return torch.zeros(p.shape, dtype=dt, device=p.device)
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          tree_lib.tree_map(zeros, params),
                          tree_lib.tree_map(zeros, params))

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp(step / float(max(self.warmup_steps, 1)), max=1.0)
        prog = torch.clamp((step - float(self.warmup_steps))
                           / float(max(self.total_steps - self.warmup_steps,
                                       1)), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return self.lr * warm * (0.1 + 0.9 * cos)

    def update(self, grads, state: AdamWState, params, decay=None
               ) -> Tuple[Any, AdamWState, torch.Tensor]:
        """(new params, new state, global grad norm).  ``decay`` is a tree
        of bools with the params' structure (``model_zoo.decay_mask``);
        None decays the leaves of two or more dimensions."""
        with torch.no_grad():
            return self._update(grads, state, params, decay)

    def _update(self, grads, state, params, decay):
        gnorm = global_norm(grads)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        # bf16-state archs (grok/mistral: HBM-bound) also run the update
        # arithmetic in bf16; float32 everywhere else, int8 state included
        # in the reference's rule: its moments dequantize to bf16 math.
        cdt = (torch.float32 if self.state_dtype == "float32"
               else torch.bfloat16)
        dev = step.device
        k = {name: _c(v, cdt, dev) for name, v in (
            ("b1", b1), ("1-b1", 1 - b1), ("b2", b2), ("1-b2", 1 - b2),
            ("eps", self.eps), ("wd", self.weight_decay))}
        scale_c, lr_c = scale.to(cdt), lr.to(cdt)
        bc1_c, bc2_c = bc1.to(cdt), bc2.to(cdt)

        def upd(p, g, m, v, dec):
            quant = isinstance(m, Quantized)
            if quant:
                m = _dequantize(m, cdt)
                v = _dequantize(v, cdt)
            g = g.to(cdt) * scale_c
            m1 = k["b1"] * m.to(cdt) + k["1-b1"] * g
            v1 = k["b2"] * v.to(cdt) + k["1-b2"] * g * g
            mh = m1 / bc1_c
            vh = v1 / bc2_c
            delta = mh / (torch.sqrt(vh) + k["eps"])
            if dec:  # decoupled weight decay on the reference's matrices
                delta = delta + k["wd"] * p.to(cdt)
            p1 = (p.to(cdt) - lr_c * delta).to(p.dtype)
            if quant:
                return p1, _quantize(m1), _quantize(v1)
            sdt = cdt if self.state_dtype != "float32" else torch.float32
            return p1, m1.to(sdt), v1.to(sdt)

        p_leaves, treedef = tree_lib.flatten(params)
        g_leaves = tree_lib.flatten_up_to(treedef, grads)
        m_leaves = tree_lib.flatten_up_to(treedef, state.m)
        v_leaves = tree_lib.flatten_up_to(treedef, state.v)
        d_leaves = ([p.ndim >= 2 for p in p_leaves] if decay is None
                    else tree_lib.flatten_up_to(treedef, decay))
        out = [upd(*a) for a in zip(p_leaves, g_leaves, m_leaves, v_leaves,
                                    d_leaves)]
        new_p = tree_lib.unflatten(treedef, [t[0] for t in out])
        new_m = tree_lib.unflatten(treedef, [t[1] for t in out])
        new_v = tree_lib.unflatten(treedef, [t[2] for t in out])
        return new_p, AdamWState(step, new_m, new_v), gnorm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    in the tree's leaf order."""
    leaves = tree_lib.flatten(tree)[0]
    total = 0
    for leaf in leaves:
        total = total + torch.sum(leaf.float() ** 2)
    return torch.sqrt(total)
