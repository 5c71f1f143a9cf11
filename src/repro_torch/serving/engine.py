"""Batched serving engine: slot-based continuous batching (lite).

Port of ``repro.serving.engine``.  A fixed-size slot array holds
concurrent sequences sharing one KV cache; requests are admitted in waves
of ``slots`` (the cache is reset per wave).  Prompts are left-padded with
token 0 and prefill runs with no pad mask, as in the reference.  Greedy or
temperature sampling on the host, with the reference's numpy Gumbel-max
sampler under ``rng_seed``, so equal logits give equal tokens.

The Dynasparse tie-in: with ``cfg.dynasparse_ffn=True`` every FFN matmul
of prefill and decode runs through ``dynasparse_matmul``
(``models.layers._linear``): both operands are profiled by the
``tile_nnz`` kernel and every (256, 256, 256) block step is planned and
run by the ``dispatch`` kernel -- the paper's runtime K2P inside an LM
serving loop.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.models.model_zoo import ModelBundle


@dataclasses.dataclass
class Request:
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 32
    request_id: int = 0


@dataclasses.dataclass
class Result:
    request_id: int
    tokens: np.ndarray              # generated tokens


class ServeEngine:
    """Slot-based LM server over a ``ModelBundle``, on the bundle's device.

    ``generate(requests)`` admits requests in waves of ``slots``: one
    left-padded prefill per wave, then one decode step per token shared by
    all slots.  Sampling is greedy at ``temperature <= 0``, else Gumbel-max
    on the host.  Sequences stop at ``max_new_tokens`` or ``max_seq``.

    Serves every decoder-only arch.  An encoder-decoder bundle is refused:
    its prefill needs the encoder's frames, which a ``Request`` does not
    carry (the reference's engine fails on it, with a ``KeyError`` in its
    prefill).
    """

    def __init__(self, bundle: ModelBundle, params, *, slots: int = 8,
                 max_seq: int = 256, temperature: float = 0.0,
                 rng_seed: int = 0):
        if bundle.cfg.encdec is not None:
            raise ValueError(
                f"{bundle.cfg.name}: ServeEngine serves decoder-only models; "
                "an encoder-decoder prefill needs frames (call the bundle's "
                "prefill and decode_step)")
        self.bundle = bundle
        self.params = params
        self.device = bundle.device
        self.slots = slots
        self.max_seq = max_seq
        self.temperature = temperature
        self.rng = np.random.default_rng(rng_seed)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        logits = logits[:, : self.bundle.cfg.vocab_size].float().cpu().numpy()
        if self.temperature <= 0:
            return logits.argmax(-1).astype(np.int32)
        # Gumbel-max: argmax(z + g) ~ Categorical(softmax(z)); one draw
        # for the whole batch, deterministic under rng_seed.
        z = logits / self.temperature
        g = self.rng.gumbel(size=z.shape)
        return (z + g).argmax(-1).astype(np.int32)

    def generate(self, requests: List[Request]) -> List[Result]:
        """Processes requests in admission waves of ``slots``."""
        results: List[Result] = []
        queue = list(requests)
        with torch.inference_mode():
            while queue:
                wave = queue[: self.slots]
                queue = queue[self.slots:]
                results.extend(self._run_wave(wave))
        return results

    def _run_wave(self, wave: List[Request]) -> List[Result]:
        b = len(wave)
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        logits, caches = self.bundle.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            max_seq=self.max_seq)
        out = [[] for _ in wave]
        cur = self._sample(logits)
        budget = np.array([r.max_new_tokens for r in wave])
        for i in range(b):
            if budget[i] > 0:
                out[i].append(int(cur[i]))
        pos = plen
        steps = int(budget.max(initial=0)) - 1
        for _ in range(max(steps, 0)):
            if pos >= self.max_seq:
                break
            step = torch.from_numpy(cur[:, None].astype(np.int64))
            logits, caches = self.bundle.decode_step(
                self.params, caches, step.to(self.device), pos)
            cur = self._sample(logits)
            pos += 1
            for i in range(b):
                if len(out[i]) < budget[i]:
                    out[i].append(int(cur[i]))
        return [Result(r.request_id, np.array(o, np.int32))
                for r, o in zip(wave, out)]
