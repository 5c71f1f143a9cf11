"""Hand-written CUDA kernels for the Dynasparse computation primitives.

``gemm``, ``spdmm``, ``spmm``, ``csr_spmm``, ``profile`` (``tile_nnz``)
and ``flash_attention`` port the Pallas kernels of ``repro.kernels``;
``dispatch`` is the executor's one-launch block path, ``dispatch_bwd``
its masked VJP on bf16 and float32 grids, and ``edge_softmax``
GAT's masked edge-softmax (jnp in the reference's
``attention_adjacency``).  Each module holds its kernel's wrapper, its
plain PyTorch version and its launch counter (``<module>.launches``;
the batched ``tile_nnz`` route counts in ``profile.batched_launches``);
``ops`` holds the padding and format wrappers, ``build`` compiles
``csrc/`` with ``nvcc`` at first use.  The counters of
``repro_torch.trace`` share the launch counts' window.
"""
from repro_torch import trace
from repro_torch.kernels import (csr_spmm, dispatch,  # noqa: F401
                                 dispatch_bwd, edge_softmax,
                                 flash_attention, gemm, ops, profile, spdmm,
                                 spmm)

KERNEL_MODULES = {"gemm": gemm, "spdmm": spdmm, "spmm": spmm,
                  "csr_spmm": csr_spmm, "dispatch": dispatch,
                  "dispatch_bwd": dispatch_bwd,
                  "tile_nnz": profile, "flash_attention": flash_attention,
                  "edge_softmax": edge_softmax}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`,
    the batched ``tile_nnz`` route under ``tile_nnz_batched``."""
    counts = {name: mod.launches for name, mod in KERNEL_MODULES.items()}
    counts["tile_nnz_batched"] = profile.batched_launches
    return counts


def reset_launch_counts() -> None:
    """Zero the launch counts and ``repro_torch.trace``'s counters."""
    trace.reset()
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
    profile.batched_launches = 0
    spdmm.launches_by_shape.clear()
    csr_spmm.launches_by_shape.clear()
