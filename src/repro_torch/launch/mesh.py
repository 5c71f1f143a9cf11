"""The dry run's meshes, as device-free named axes.

Port of ``repro.launch.mesh``.  The reference builds its production
meshes on 256 or 512 forced host devices; one card cannot hold such a
mesh and the dry run needs none, so these are
:class:`~repro_torch.distributed.sharding.NamedMesh` values: axis names
and sizes.  The reference's ``TPU_PERF_FLAGS`` (XLA's TPU scheduler
flags) have no counterpart.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import NamedMesh


def make_production_mesh(*, multi_pod: bool = False) -> NamedMesh:
    """Single pod: (data=16, model=16) = 256 chips (one v5e pod).
    Multi-pod: (pod=2, data=16, model=16) = 512 chips; the ``pod`` axis is
    pure data parallelism."""
    if multi_pod:
        return NamedMesh((2, 16, 16), ("pod", "data", "model"))
    return NamedMesh((16, 16), ("data", "model"))


def make_test_mesh(n_devices: int = 8, model: int = 4) -> NamedMesh:
    """The reference's small unit-test mesh: (n_devices // model, model)
    over ("data", "model")."""
    return NamedMesh((n_devices // model, model), ("data", "model"))
