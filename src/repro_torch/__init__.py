"""PyTorch/CUDA port of the Dynasparse reproduction (see ``repro``)."""
