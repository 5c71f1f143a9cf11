"""Hand-written CUDA kernels for the Dynasparse computation primitives.

``gemm``, ``spdmm``, ``spmm`` and ``csr_spmm`` port the Pallas kernels of
``repro.kernels``; ``dispatch`` is the executor's one-launch block path.
Each module holds its kernel's wrapper, its plain PyTorch version and its
launch counter (``<module>.launches``); ``ops`` holds the padding and
format wrappers, ``build`` compiles ``csrc/`` with ``nvcc`` at first use.
"""
from repro_torch.kernels import (csr_spmm, dispatch, gemm, ops,  # noqa: F401
                                 spdmm, spmm)

KERNEL_MODULES = {"gemm": gemm, "spdmm": spdmm, "spmm": spmm,
                  "csr_spmm": csr_spmm, "dispatch": dispatch}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
