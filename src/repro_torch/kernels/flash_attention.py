"""FlashAttention forward kernel (online softmax).

Port of ``repro.kernels.flash_attention`` (the Pallas kernel at
``src/repro/kernels/flash_attention.py:75``).  Not part of the paper: it is
the LM-side hot spot of the framework the technique is embedded in.  The
CUDA kernels are in ``csrc/flash_attention.cu``: one CTA per (b*h, block of
query rows), K/V streamed through shared memory, running max and
denominator in float32, GQA kv heads read in place.  The route follows the
type, in the open (:data:`ROUTES`): bfloat16 goes to the tensor-core
kernel (``mma.sync``, P rounded to bf16 for P V), float32 to the first
version on the FP32 FMA units, which the float32 checks at 3e-4 need.

:func:`flash_attention_plain` is the plain PyTorch version of the same
function, including the reference kernel's edge semantics: causal queries
aligned to the end of the kv sequence, kv blocks strictly in the future of
a whole ``bq``-block never processed, masked scores at -1e30 (a row whose
processed keys are all masked averages them uniformly) and the output
divided by ``max(l, 1e-30)``.  Forward only: the reference kernel has no
VJP either.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
NEG_INF = -1e30
# dtype -> C entry point of csrc/flash_attention.cu
ROUTES = {torch.bfloat16: "rt_flash_attention_bf16",
          torch.float32: "rt_flash_attention_f32"}
HEAD_DIMS = (16, 32, 64, 128)


def _check(q, k, v, bq, bk):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be "
                         "(B, H, S, D) with equal k and v")
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    if sq % bq or k.shape[2] % bk:
        raise ValueError(f"flash_attention: Sq={sq}, Skv={k.shape[2]} must "
                         f"be multiples of bq={bq}, bk={bk} (ops pads)")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False, bq: int = 128,
                          bk: int = 128) -> torch.Tensor:
    """The kernel's function on full score matrices, in float32."""
    _check(q, k, v, bq, bk)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    rep = h // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (d ** -0.5)
    if causal:
        off = skv - sq
        rows = torch.arange(sq, device=q.device)
        keys = torch.arange(skv, device=q.device)
        q_end = (rows // bq + 1) * bq - 1 + off
        limit = torch.where(q_end < 0, 0, torch.clamp(
            (torch.clamp(q_end, min=0) // bk + 1) * bk, max=skv))
        s = torch.where(keys[None, :] <= (rows + off)[:, None], s, NEG_INF)
        s = torch.where(keys[None, :] < limit[:, None], s, float("-inf"))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    out = out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, H, Sq, D) in q's
    type.  Sq % bq == 0 and Skv % bk == 0 (``ops.flash_attention`` pads);
    query head h reads kv head h // (H / Hkv).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of its type (bfloat16: tensor cores; float32: FMA units), D in
    16/32/64/128, or raises.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
    global launches
    _check(q, k, v, bq, bk)
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS or q.dtype not in ROUTES:
        raise ValueError(f"flash_attention: head dim {d} / dtype {q.dtype} "
                         f"not supported by the kernels ({HEAD_DIMS}, "
                         "float32 or bfloat16)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(f"flash_attention {name}", t, q.dtype)
        if q.dtype == torch.bfloat16:      # 16-byte cp.async rows
            build.require_aligned(f"flash_attention {name}", t)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.function("flash_attention", ROUTES[q.dtype],
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                        + [ctypes.c_float, ctypes.c_void_p])
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, h, k.shape[1], sq, k.shape[2], d, bq, bk, int(causal),
                   d ** -0.5, build.stream(q)), "flash_attention")
    launches += 1
    return out
