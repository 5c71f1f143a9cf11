"""ModelBundle: one handle over the port's LM architectures.

Port of ``repro.models.model_zoo`` for decoder-only configs (enc-dec
waits, ROADMAP queue 1).  ``build(cfg, device)`` returns init / loss /
prefill / decode closures on one device: the card unless the caller
passes ``device="cpu"``.  :func:`params_from_reference` carries a JAX
param pytree (as numpy arrays) into the port's layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import transformer

FLOAT32_LEAVES = ("ln1", "ln2", "final_norm", "qnorm", "knorm")


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable[..., Dict]
    loss_fn: Callable[[Dict, Dict], torch.Tensor]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_caches: Callable[..., Dict]


def build(cfg: ModelConfig, device: DeviceLike = None) -> ModelBundle:
    """Bundle for a decoder-only ``cfg`` on ``device`` (default: CUDA,
    raising without a card)."""
    if cfg.encdec is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are {transformer.NOT_PORTED}")
    transformer.check_dense(cfg)
    dev = resolve(device)

    def init_params(rng: Union[int, torch.Generator] = 0) -> Dict:
        """Random params from a seed or a ``torch.Generator`` on the
        bundle's device."""
        gen = rng
        if not isinstance(rng, torch.Generator):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(rng))
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, bundle on {dev}")
        return transformer.init_params(cfg, gen)

    return ModelBundle(
        cfg=cfg,
        device=dev,
        init_params=init_params,
        loss_fn=lambda p, b: transformer.loss_fn(cfg, p, b),
        prefill=lambda p, b, **kw: transformer.prefill(
            cfg, p, b["tokens"], **kw),
        decode_step=lambda p, c, t, pos: transformer.decode_step(
            cfg, p, c, t, pos),
        init_caches=lambda batch, max_seq: transformer.init_caches(
            cfg, batch, max_seq, dev),
    )


def _convert(tree: Any, dtype: torch.dtype, dev: torch.device,
             f32: bool = False) -> Any:
    if isinstance(tree, Mapping):
        return {k: _convert(v, dtype, dev, f32 or k in FLOAT32_LEAVES)
                for k, v in tree.items()}
    arr = np.array(tree, np.float32)
    return torch.from_numpy(arr).to(
        device=dev, dtype=torch.float32 if f32 else dtype)


def params_from_reference(params_np: Mapping, cfg: ModelConfig,
                          device: DeviceLike = None) -> Dict:
    """The reference's param pytree, its leaves as numpy arrays (bfloat16
    leaves given as float32, which is lossless), in the port's layout.

    Takes the reference's ``stack`` layout (one list entry per period
    position, each leaf with a leading ``n_periods`` axis) and its
    ``layers`` layout (one dict per layer).  Norm gains stay float32, as
    the reference keeps them; every other leaf takes ``cfg.dtype``.
    """
    transformer.check_dense(cfg)
    dev = resolve(device)
    dtype = cfg.jdtype
    if "stack" in params_np:
        stack = params_np["stack"]
        n_periods = len(np.asarray(stack[0]["ln1"]["scale"]))

        def layer(tree, i):
            if isinstance(tree, Mapping):
                return {k: layer(v, i) for k, v in tree.items()}
            return np.asarray(tree)[i]

        layers = [layer(stack[posn], i) for i in range(n_periods)
                  for posn in range(len(stack))]
    else:
        layers = list(params_np["layers"])
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the reference params, "
                         f"{cfg.n_layers} in {cfg.name}")
    out = {k: _convert(v, dtype, dev, k in FLOAT32_LEAVES)
           for k, v in params_np.items() if k not in ("stack", "layers")}
    out["layers"] = [_convert(lp, dtype, dev) for lp in layers]
    return out
