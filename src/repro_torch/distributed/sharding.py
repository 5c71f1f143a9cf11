"""Sharding rules: the serving mesh of the GNN path and the LM rules of
the dry run.

Port of ``repro.distributed.sharding``.  The GNN part: each device of a
1-D ``cores`` mesh plays one of the paper's Computation Cores and runs
its own slice of an admission wave:

* :class:`CoresMesh` -- a frozen tuple of ``torch.device`` over
  :data:`CORES_AXIS`; :func:`cores_mesh` builds one from the visible cards,
  or as emulated lanes on one device;
* :func:`partition_devices` / :func:`partition_mesh` -- disjoint per-lane
  device groups (an exact cover of the mesh);
* :func:`abstract_cores_mesh` -- the device-free key of a group size:
  equal-size groups share one walk plan;
* :func:`wave_slices` / :func:`shard_wave` -- the one placement rule of a
  wave's slots: device d of a D-lane group owns slots ``[d*B/D,
  (d+1)*B/D)``.  The executor walks each lane's range on its device and
  the engine places requests into those ranges.

The LM part (FSDP + TP by construction, divisibility-guarded) gives each
leaf of a param, optimizer-state, cache or batch tree its
:class:`PartitionSpec` on a :class:`NamedMesh`, a device-free mesh of
named axes (``launch.mesh``): every rank>=2 param leaf shards its LAST
dim over ``model`` (its second-to-last for the row-parallel
projections) and the other of the two over ``data``, whenever
divisible; expert leaves under expert parallelism shard the expert dim
over ``data``; caches shard the batch dim over (pod, data) and the
minor-most divisible dim over ``model``.  Paths are the port's tree
paths (``train.tree.flatten_with_path``: dict keys, list indices,
NamedTuple fields).  Nothing is placed: one card holds every tensor
whole, and the dry run reads the specs to count per-device bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as _device
from repro_torch.train import tree as tree_lib

__all__ = ["CORES_AXIS", "CoresMesh", "AbstractCoresMesh", "cores_mesh",
           "partition_devices", "partition_mesh", "abstract_cores_mesh",
           "wave_slices", "shard_wave", "NamedMesh", "PartitionSpec", "P",
           "NamedSharding", "batch_axes", "param_spec", "param_shardings",
           "cache_spec", "cache_shardings", "batch_spec", "batch_shardings",
           "replicated", "describe", "shard_bytes"]

# the serving mesh axis: each device along it runs its own slice of a wave
CORES_AXIS = "cores"


@dataclasses.dataclass(frozen=True)
class CoresMesh:
    """A 1-D serving mesh: ``devices[d]`` runs lane d of every wave.

    The devices may repeat (:func:`cores_mesh` with ``device=``): such
    lanes are emulated, and run one after another on their device."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (CORES_AXIS,)

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(_indexed(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(d) -> torch.device:
    """``d`` as the device its tensors report (``cuda`` -> ``cuda:i``)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class AbstractCoresMesh:
    """A device-free ``cores`` mesh: only the group size."""

    size: int
    axis_names: Tuple[str, ...] = (CORES_AXIS,)


def cores_mesh(n_devices: Optional[int] = None,
               device: _device.DeviceLike = None) -> CoresMesh:
    """1-D serving mesh over :data:`CORES_AXIS`.

    With no ``device``, the first ``n_devices`` CUDA cards (all of them by
    default); a count outside ``1..torch.cuda.device_count()`` raises
    ``ValueError``.  With ``device=d``, ``n_devices`` (default 1)
    EMULATED lanes, all on ``d``: the port's counterpart of the
    reference's forced host-device count.  Emulated lanes run one after
    another on one device, so their walls measure no multi-device speed;
    they exercise the placement, the per-lane walks and the scheduler's
    group plans exactly as distinct cards would."""
    if device is not None:
        dev = _device.resolve(device)
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"cores_mesh({n_devices}) emulates no lanes")
        return CoresMesh((dev,) * n)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if not 0 < n <= visible:
        raise ValueError(
            f"cores_mesh({n_devices}) with {visible} devices visible")
    return CoresMesh(tuple(torch.device("cuda", i) for i in range(n)))


def partition_devices(devices: Sequence, group_sizes: Sequence[int]
                      ) -> List[list]:
    """Split ``devices`` into contiguous disjoint groups of ``group_sizes``.

    Every device lands in exactly ONE group, groups keep device order, and
    the sizes must be an exact cover -- each positive, summing to
    ``len(devices)``.  Anything else raises ``ValueError``: a dispatch
    layer must never drop or double-book a device."""
    sizes = [int(s) for s in group_sizes]
    if not sizes:
        raise ValueError("partition into zero groups")
    bad = [s for s in sizes if s < 1]
    if bad:
        raise ValueError(f"group sizes must be >= 1, got {sizes}")
    if sum(sizes) != len(devices):
        raise ValueError(
            f"group sizes {sizes} sum to {sum(sizes)}, not the "
            f"{len(devices)} devices to partition")
    out, at = [], 0
    for s in sizes:
        out.append(list(devices[at: at + s]))
        at += s
    return out


def partition_mesh(mesh: CoresMesh, group_sizes: Sequence[int]
                   ) -> List[CoresMesh]:
    """Partition a 1-D ``cores`` mesh into disjoint per-lane submeshes
    (:func:`partition_devices`), each its own 1-D ``cores`` mesh, so that
    lanes run waves on separate devices.  The executor keys its walk plans
    on the group SIZE (:func:`abstract_cores_mesh`), so equal-size groups
    share one plan."""
    if len(mesh.axis_names) != 1 or mesh.axis_names[0] != CORES_AXIS:
        raise ValueError(
            f"partition_mesh needs a 1-D {CORES_AXIS!r} mesh, got "
            f"{mesh.axis_names}")
    return [CoresMesh(tuple(g))
            for g in partition_devices(list(mesh.devices), group_sizes)]


def abstract_cores_mesh(n_devices: int) -> AbstractCoresMesh:
    """Device-free 1-D ``cores`` mesh of ``n_devices``: the plan key of a
    sharded wave, so that every device group of one size shares a walk
    plan (one per (bucket, group size))."""
    if n_devices < 1:
        raise ValueError(f"abstract_cores_mesh({n_devices})")
    return AbstractCoresMesh(int(n_devices))


def wave_slices(n_slots: int, lanes: int) -> List[slice]:
    """The slot range of each lane of a ``lanes``-device group: lane d owns
    ``[d*n_slots/lanes, (d+1)*n_slots/lanes)``.  Whole slots, so a lane's
    view of a stack keeps the stack's 16-byte slot alignment."""
    if lanes < 1 or n_slots % lanes:
        raise ValueError(
            f"wave of {n_slots} slots not divisible by {lanes} mesh "
            f"devices")
    per = n_slots // lanes
    return [slice(d * per, (d + 1) * per) for d in range(lanes)]


def shard_wave(batched: Dict[str, torch.Tensor], mesh: CoresMesh
               ) -> List[Dict[str, torch.Tensor]]:
    """Each lane's slot range of every stacked ``(B, ...)`` wave input, on
    that lane's device: a view where the stack already lies there, else
    one asynchronous copy per lane (from pinned host memory it overlaps
    device work)."""
    b = int(next(iter(batched.values())).shape[0])
    return [{name: v[sl].to(dev, non_blocking=True)
             for name, v in batched.items()}
            for dev, sl in zip(mesh.devices, wave_slices(b, mesh.size))]


# --------------------------------------------------------------------------
# The LM rules (the dry run's meshes of named axes)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedMesh:
    """A device-free mesh: axis names and their sizes (``shape``), as the
    reference's ``AbstractMesh``.  A mesh of 256 or 512 chips cannot be
    real on one card, and the rules need none."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


class PartitionSpec(tuple):
    """Per dimension: ``None`` (replicated), a mesh axis name, or a tuple
    of names (sharded over their product).  Dimensions past the spec's
    length are replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: its spec on a mesh."""

    mesh: NamedMesh
    spec: PartitionSpec


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axsize(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


# Megatron convention: down/output projections are ROW-parallel (their
# contraction dim -- the previous op's model-sharded output -- shards over
# `model`); everything else is column-parallel.
ROW_PARALLEL_NAMES = ("w2", "wo", "we2", "out_proj", "down", "dt_proj")


def param_spec(mesh, shape: Tuple[int, ...],
               row_parallel: bool = False) -> PartitionSpec:
    if len(shape) < 2:
        return P()
    spec = [None] * len(shape)
    model_n = _axsize(mesh, "model") if "model" in mesh.axis_names else 0
    data_n = _axsize(mesh, "data") if "data" in mesh.axis_names else 0
    mdim, ddim = (-2, -1) if row_parallel else (-1, -2)
    if model_n > 1 and shape[mdim] % model_n == 0:
        spec[mdim] = "model"
    if data_n > 1 and shape[ddim] % data_n == 0:
        spec[ddim] = "data"
    elif model_n > 1 and spec[mdim] is None and shape[ddim] % model_n == 0:
        spec[ddim] = "model"
    return P(*spec)


def _last_name(path) -> Optional[str]:
    """The innermost key of ``path`` that names something: list indices
    are skipped, and so are the ``q``/``s`` fields of a quantized
    optimizer moment (``train.optimizer.Quantized``)."""
    for k in reversed(path):
        if isinstance(k, str) and k and k not in ("q", "s"):
            return k
    return None


def _is_row_parallel(path) -> bool:
    return _last_name(path) in ROW_PARALLEL_NAMES


def _is_expert(path) -> bool:
    return _last_name(path) in ("we1", "we2", "we3")


def expert_param_spec(mesh, shape, row_parallel: bool) -> PartitionSpec:
    """EP: experts over `data`, TP over `model` inside each expert."""
    spec = [None] * len(shape)
    data_n = _axsize(mesh, "data") if "data" in mesh.axis_names else 0
    model_n = _axsize(mesh, "model") if "model" in mesh.axis_names else 0
    edim = len(shape) - 3
    if data_n > 1 and shape[edim] % data_n == 0:
        spec[edim] = "data"
    mdim = -2 if row_parallel else -1
    if model_n > 1 and shape[mdim] % model_n == 0:
        spec[mdim] = "model"
    return P(*spec)


def param_shardings(mesh, params, *, ep_experts: bool = False) -> Any:
    """A :class:`NamedSharding` for every leaf of ``params`` (anything with
    a ``shape``: tensors, meta tensors), in its structure."""
    def leaf(path, x):
        shape = tuple(x.shape)
        row = _is_row_parallel(path)
        if ep_experts and _is_expert(path) and len(shape) >= 3:
            return NamedSharding(mesh, expert_param_spec(mesh, shape, row))
        return NamedSharding(mesh, param_spec(mesh, shape,
                                              row_parallel=row))
    return tree_lib.tree_map_with_path(leaf, params)


def cache_spec(mesh, shape: Tuple[int, ...], batch: int) -> PartitionSpec:
    spec = [None] * len(shape)
    ba = batch_axes(mesh)
    bn = _axsize(mesh, ba) if ba else 0
    model_n = _axsize(mesh, "model") if "model" in mesh.axis_names else 0
    # the batch dim: the first dim equal to the global batch among the
    # first two (a stacked layout leads with its layer dim)
    bdim = None
    for d, sz in enumerate(shape):
        if sz == batch and d <= 1:
            bdim = d
            break
    if bdim is not None and bn > 1 and batch % bn == 0:
        spec[bdim] = ba if len(ba) > 1 else ba[0]
    if model_n > 1:
        # the MINOR-most divisible dim (head_dim / MLA latent / d_inner):
        # decode writes one token per step along seq
        cands = [d for d, sz in enumerate(shape)
                 if spec[d] is None and d != 0 and sz % model_n == 0]
        if cands:
            spec[cands[-1]] = "model"
    return P(*spec)


def cache_shardings(mesh, caches, batch: int) -> Any:
    return tree_lib.tree_map(
        lambda x: NamedSharding(mesh, cache_spec(mesh, tuple(x.shape),
                                                 batch)), caches)


def batch_spec(mesh, shape: Tuple[int, ...], batch: int) -> PartitionSpec:
    if not shape or shape[0] != batch:
        return P()
    ba = batch_axes(mesh)
    bn = _axsize(mesh, ba)
    if bn > 1 and batch % bn == 0:
        return P(ba if len(ba) > 1 else ba[0])
    return P()


def batch_shardings(mesh, batch_tree, batch: int) -> Any:
    return tree_lib.tree_map(
        lambda x: NamedSharding(mesh, batch_spec(mesh, tuple(x.shape),
                                                 batch)), batch_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def describe(shardings, max_lines: int = 0) -> str:
    """Report helper: ``path: spec``, one line per leaf."""
    lines = [f"{_keystr(path)}: {s.spec}"
             for path, s in tree_lib.flatten_with_path(shardings)]
    if max_lines:
        lines = lines[:max_lines]
    return "\n".join(lines)


def shard_bytes(x, sharding: NamedSharding) -> float:
    """Bytes of ``x``'s shard on one device under ``sharding``: its bytes
    over the product of the sizes of the axes its spec names (the rules
    shard a dimension only where it divides)."""
    nbytes = x.numel() * x.element_size()
    return nbytes / math.prod(_axsize(sharding.mesh, d)
                              for d in sharding.spec if d is not None)
