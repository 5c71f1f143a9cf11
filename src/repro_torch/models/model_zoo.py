"""ModelBundle: one handle over all ten LM architectures.

Port of ``repro.models.model_zoo``.  ``build(cfg, device)`` returns init /
loss / prefill / decode closures dispatching on the family (decoder-only
or encoder-decoder), on one device: the card unless the caller passes
``device="cpu"`` (or ``"meta"``, where ``init_params`` raises: the meta
device has no generator; :func:`abstract_params` builds that tree).
:func:`input_specs`, :func:`abstract_params` and :func:`abstract_caches`
give a cell's trees on the meta device, for the dry run.
:func:`params_from_reference` carries a JAX param pytree (as numpy
arrays) into the port's layout; :func:`decay_mask` gives each port leaf
the weight-decay decision the reference's AdamW takes on its own
layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import META


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable[..., Dict]
    loss_fn: Callable[[Dict, Dict], torch.Tensor]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_caches: Callable[..., Dict]


def _module(cfg: ModelConfig):
    return encdec if cfg.encdec is not None else transformer


def build(cfg: ModelConfig, device: DeviceLike = None) -> ModelBundle:
    """Bundle for ``cfg`` on ``device`` (default: CUDA, raising without a
    card)."""
    dev = resolve(device)
    mod = _module(cfg)

    def init_params(rng: Union[int, torch.Generator] = 0) -> Dict:
        """Random params from a seed or a ``torch.Generator`` on the
        bundle's device."""
        gen = rng
        if not isinstance(rng, torch.Generator):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(rng))
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, bundle on {dev}")
        return mod.init_params(cfg, gen)

    if cfg.encdec is not None:
        return ModelBundle(
            cfg=cfg,
            device=dev,
            init_params=init_params,
            loss_fn=lambda p, b: encdec.loss_fn(cfg, p, b),
            prefill=lambda p, b, **kw: encdec.prefill(
                cfg, p, b["frames"], b["tokens"], **kw),
            decode_step=lambda p, c, t, pos: encdec.decode_step(
                cfg, p, c, t, pos),
            init_caches=lambda batch, max_seq,
            enc_len=encdec.ENC_DECODE_LEN: encdec.init_caches(
                cfg, batch, max_seq, enc_len, dev),
        )
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


# --------------------------------------------------------------------------
# Abstract trees: every input, param and cache of a cell on the meta device
# (shapes and dtypes, no storage)
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict[str, Any]:
    """The inputs of an (arch x shape) cell as meta tensors, with the
    reference's shapes and dtypes (int32 tokens).

    train:   {tokens, labels [, frames]}
    prefill: {tokens [, frames]}
    decode:  {tokens (B, 1), pos ()} -- the caches come from
             :func:`abstract_caches`.
    Whisper's decoder runs ``max(S // dec_ratio, 64)`` tokens against S
    frames.
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), i32), "pos": _meta((), i32)}
    if cfg.encdec is not None:
        dec = max(s // cfg.encdec.dec_ratio, 64)
        out = {"frames": _meta((b, s, cfg.d_model), cfg.jdtype),
               "tokens": _meta((b, dec), i32)}
        if shape.kind == "train":
            out["labels"] = _meta((b, dec), i32)
        return out
    out = {"tokens": _meta((b, s), i32)}
    if shape.kind == "train":
        out["labels"] = _meta((b, s), i32)
    return out


def abstract_params(cfg: ModelConfig) -> Dict:
    """The params of ``cfg`` on the meta device, built without a
    ``torch.Generator`` (there is none for the meta device)."""
    return _module(cfg).init_params(cfg, META)


def abstract_caches(cfg: ModelConfig, shape: ShapeCfg) -> Dict:
    """The decode caches of a cell on the meta device: ``global_batch``
    sequences of ``seq_len`` (whisper's cross caches over
    ``encdec.ENC_DECODE_LEN`` frames, as the reference's)."""
    return build(cfg, META).init_caches(shape.global_batch, shape.seq_len)


def _take(tree: Any, i: int) -> Any:
    """Entry ``i`` of every leaf's leading (stacked) axis."""
    if isinstance(tree, Mapping):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _unstack(params_np: Mapping) -> Dict:
    """The reference's scanned layouts as one dict per layer: ``stack``
    (one entry per period position, each leaf with a leading
    ``n_periods`` axis; layer j is position j % period of period
    j // period) and ``enc_stack``/``dec_stack`` (leading layer axis)."""
    out = {k: v for k, v in params_np.items()
           if k not in ("stack", "enc_stack", "dec_stack")}
    if "stack" in params_np:
        stack = params_np["stack"]
        period = len(stack)
        n_periods = len(np.asarray(stack[0]["ln1"]["scale"]))
        out["layers"] = [_take(stack[j % period], j // period)
                         for j in range(n_periods * period)]
    for key, layers in (("enc_stack", "enc_layers"),
                        ("dec_stack", "dec_layers")):
        if key in params_np:
            n = len(np.asarray(params_np[key]["ln1"]["scale"]))
            out[layers] = [_take(params_np[key], i) for i in range(n)]
    return out


def _convert(tree: Any, like: Any, dev: torch.device, path: str) -> Any:
    if isinstance(like, Mapping):
        if not isinstance(tree, Mapping) or set(tree) != set(like):
            have = sorted(tree) if isinstance(tree, Mapping) else type(tree)
            raise ValueError(f"reference params at {path or '/'}: {have}, "
                             f"the port's layout has {sorted(like)}")
        return {k: _convert(tree[k], like[k], dev, f"{path}/{k}")
                for k in like}
    if isinstance(like, list):
        if len(tree) != len(like):
            raise ValueError(f"{len(tree)} layers in the reference params "
                             f"at {path}, {len(like)} in the config")
        return [_convert(t, lk, dev, f"{path}/{i}")
                for i, (t, lk) in enumerate(zip(tree, like))]
    arr = np.array(tree, np.float32)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"reference param {path} has shape {arr.shape}, "
                         f"the port's {tuple(like.shape)}")
    return torch.from_numpy(arr).to(device=dev, dtype=like.dtype)


def params_from_reference(params_np: Mapping, cfg: ModelConfig,
                          device: DeviceLike = None) -> Dict:
    """The reference's param pytree, its leaves as numpy arrays (bfloat16
    leaves given as float32, which is lossless), in the port's layout.

    Takes every layout of the reference: ``stack`` with any period,
    ``dense_first``, ``layers``, ``enc_stack``/``dec_stack`` and
    ``enc_layers``/``dec_layers``, and nested leaves (a MoE layer's
    ``shared`` experts).  Each leaf takes the dtype and must have the
    shape of the port's own ``init_params`` at the same path, built on
    the meta device.
    """
    dev = resolve(device)
    return _convert(_unstack(params_np), abstract_params(cfg), dev, "")


STACKED = ("layers", "enc_layers", "dec_layers")


def decay_mask(cfg: ModelConfig) -> Dict:
    """Per leaf of the port's params, whether the reference's AdamW decays
    it: ``p.ndim >= 2`` in the reference's layout.  Under ``scan_layers``
    (the default) every leaf of ``layers`` (the reference's ``stack``) and
    of ``enc_layers``/``dec_layers`` (``enc_stack``/``dec_stack``) carries
    a leading layer axis there, so a layer's norm scales and biases are
    decayed; ``dense_first`` layers, the final norms and the embeddings
    keep their own shapes.  Built from the params on the meta device: no
    device is touched."""
    like = abstract_params(cfg)

    def mark(tree, extra):
        if isinstance(tree, Mapping):
            return {k: mark(v, extra) for k, v in tree.items()}
        if isinstance(tree, list):
            return [mark(v, extra) for v in tree]
        return tree.ndim + extra >= 2

    return {k: mark(v, int(cfg.scan_layers and k in STACKED))
            for k, v in like.items()}
