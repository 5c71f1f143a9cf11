"""The serving mesh: one device per Computation Core.

Port of the GNN part of ``repro.distributed.sharding`` (the LM rules come
with the dry run).  Each device of a 1-D ``cores`` mesh plays one of the
paper's Computation Cores and runs its own slice of an admission wave:

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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as _device

__all__ = ["CORES_AXIS", "CoresMesh", "AbstractCoresMesh", "cores_mesh",
           "partition_devices", "partition_mesh", "abstract_cores_mesh",
           "wave_slices", "shard_wave"]

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
