"""Atomic checkpoints with async save, in the reference's on-disk format.

Port of ``repro.train.checkpoint``.  Layout:

    <dir>/step_<N>/
        manifest.json        {step, treedef, leaves: [{file, shape, dtype}]}
        leaf-000123.npy      one file per tree leaf
    <dir>/LATEST             text file: "step_<N>" (atomic rename)

Leaves are flattened in JAX's order (``train/tree.py``), so a tree of the
same nesting writes the same leaf files as the reference, and either
package's ``restore`` reads the other's.  numpy has no bfloat16 or fp8:
those leaves are stored as their raw bits (uint16 / uint8) with the
logical dtype's name in the manifest, and decoded by viewing the bits as
the torch dtype (no ``ml_dtypes``).  A step is written into
``step_<N>.tmp`` and renamed; ``LATEST`` is replaced last.

``save_async`` copies every leaf to host memory before it returns and
writes in a background thread, so the train loop resumes after the copy,
not the disk write.  The copy is a real one on every device: on the CPU
``t.detach().cpu()`` would share storage with the live tensor and race
the next step.  Leaf files are written by a pool of ``IO_THREADS``
threads (numpy's file I/O releases the interpreter lock), which matters
at full width: a llama3.2-1b train state is 12.4 GB.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train import tree as tree_lib

# logical dtype -> (torch dtype, the signed integer type of its width that
# torch and numpy both read, the unsigned type the reference stores)
_BIT_VIEW = {"bfloat16": (torch.bfloat16, np.int16, np.uint16),
             "float8_e4m3fn": (torch.float8_e4m3fn, np.int8, np.uint8),
             "float8_e5m2": (torch.float8_e5m2, np.int8, np.uint8)}
IO_THREADS = min(8, os.cpu_count() or 1)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as it is stored, and its logical dtype name.
    A CUDA tensor is copied into pinned memory: a copy into fresh pageable
    memory ran at 1.9 GiB/s on an H100's host (page faults), one into
    pinned memory at 2.4 GiB/s the first time and at 42 GiB/s once
    PyTorch's host allocator had cached the buffers for the next save
    (``tools/host_copy_bench.py``).  The cache keeps them: up to twice
    the state's bytes of pinned host memory (sizes round up to powers of
    two)."""
    name = _dtype_name(t)
    t = t.detach()
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
    else:
        host = t.clone()
    view = _BIT_VIEW.get(name)
    if view is not None:
        signed = torch.int16 if host.element_size() == 2 else torch.int8
        return host.view(signed).numpy().view(view[2]), name
    return host.numpy(), name


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    view = _BIT_VIEW.get(name)
    if view is not None:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            view[1])).view(view[0])
    return torch.from_numpy(arr)


def _leaf_name(i: int) -> str:
    return f"leaf-{i:06d}.npy"


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous atomic save (after any pending async write).  Returns the
    committed directory."""
    wait()
    leaves, treedef = tree_lib.flatten(tree)
    return _write(ckpt_dir, step, [_to_host(t) for t in leaves], treedef)


_save_thread: Optional[threading.Thread] = None
_save_error: List[Exception] = []


def save_async(ckpt_dir: str, step: int, tree: Any) -> None:
    """Copy to host memory now, write in the background (joins any previous
    write first)."""
    global _save_thread
    leaves, treedef = tree_lib.flatten(tree)
    host = [_to_host(t) for t in leaves]
    wait()

    def run():
        try:
            _write(ckpt_dir, step, host, treedef)
        except Exception as e:  # re-raised by wait()
            _save_error.append(e)

    _save_thread = threading.Thread(target=run, daemon=True)
    _save_thread.start()


def wait() -> None:
    """Join the pending async write; raise what it raised."""
    global _save_thread
    if _save_thread is not None:
        _save_thread.join()
        _save_thread = None
    if _save_error:
        raise _save_error.pop()


def _write(ckpt_dir: str, step: int, host_leaves: List[Tuple[np.ndarray,
                                                              str]],
           treedef) -> str:
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": tree_lib.describe(treedef),
                "leaves": [{"file": _leaf_name(i), "shape": list(raw.shape),
                            "dtype": dtype_name}
                           for i, (raw, dtype_name) in enumerate(host_leaves)]}
    with ThreadPoolExecutor(IO_THREADS) as pool:
        list(pool.map(lambda i: np.save(os.path.join(tmp, _leaf_name(i)),
                                        host_leaves[i][0]),
                      range(len(host_leaves))))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    latest = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return int(f.read().strip().split("_")[1])


def restore(ckpt_dir: str, tree_like: Any, *,
            step: Optional[int] = None) -> Tuple[Any, int]:
    """Load a checkpoint into ``tree_like``'s structure, each leaf on the
    device of ``tree_like``'s leaf at its place, in the dtype it was saved
    in.  Raises ``FileNotFoundError`` when there is none."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]
    flat, treedef = tree_lib.flatten(tree_like)
    if len(flat) != len(leaves_meta):
        raise ValueError(f"checkpoint has {len(leaves_meta)} leaves, the "
                         f"tree has {len(flat)}: architecture mismatch")
    out = []
    for meta, ref in zip(leaves_meta, flat):
        # a leaf bound for the card is copied from the file's mapped pages
        # (3.4x a load into fresh host memory and a copy from it, in
        # tools/host_copy_bench.py); one for the CPU gets memory of its own
        mapped = ref.device.type != "cpu" and ref.numel() > 0
        arr = _decode(np.load(os.path.join(d, meta["file"]),
                              mmap_mode="c" if mapped else None),
                      meta["dtype"])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{meta['file']}: shape {tuple(arr.shape)}, "
                             f"the tree's {tuple(ref.shape)}")
        out.append(arr.to(ref.device))
    return tree_lib.unflatten(treedef, out), step


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
