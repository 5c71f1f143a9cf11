"""The port's device-group policy against the JAX package's, on the CPU.

``sharding.partition_devices``, ``scheduler.plan_groups`` and
``scheduler.plan_lanes`` are pure functions in both packages: on the same
draws the port must return what the reference returns, or raise a
``ValueError`` with the same text.  Each property is a plain checker;
hypothesis drives it where installed and a seeded sweep always does
(``tests/test_submesh_partition.py``'s pattern).  Then the reference's
pinned policy examples (``tests/test_submesh_partition.py``,
``tests/test_overload.py``) and the mesh helpers, inside the port.
"""
import numpy as np
import pytest
import torch

from repro.distributed import sharding as j_sh
from repro.serving import scheduler as j_sch
from repro_torch.distributed import sharding
from repro_torch.serving.scheduler import plan_groups, plan_lanes

from conftest import HAVE_HYPOTHESIS, given, settings, st


def _same(port_fn, ref_fn, *args, **kw):
    """The port's result equals the reference's, or both raise a
    ValueError with the same text."""
    try:
        want = ref_fn(*args, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_fn(*args, **kw)
        assert str(got.value) == str(e)
        return None
    got = port_fn(*args, **kw)
    assert got == want and type(got) is type(want)
    return got


# -- checkers (shared by hypothesis and the seeded sweeps) ------------------

def check_partition(group_sizes):
    """Exact covers, and every kind of non-cover, as the reference has
    them: a short and a long sum, a zero and a negative group, no
    groups."""
    n = sum(group_sizes)
    devices = list(range(n))
    groups = _same(sharding.partition_devices, j_sh.partition_devices,
                   devices, group_sizes)
    assert [d for g in groups for d in g] == devices
    for devs, sizes in ((devices + [n], group_sizes),
                        (devices, list(group_sizes) + [1]),
                        (devices + [n], [0] + list(group_sizes)),
                        (devices, [-1, 1] + list(group_sizes)),
                        ([], [])):
        with pytest.raises(ValueError):
            sharding.partition_devices(devs, sizes)
        _same(sharding.partition_devices, j_sh.partition_devices, devs,
              sizes)


def check_plan_groups(n_devices, demands, slots, max_groups):
    sizes = _same(plan_groups, j_sch.plan_groups, n_devices, demands,
                  slots, max_groups=max_groups)
    if sizes is not None:
        assert sum(sizes) == n_devices and all(slots % s == 0 for s in sizes)


def check_plan_lanes(n_devices, demands, slots, max_lanes, walls):
    wall = None if walls is None else (lambda s: walls[s % len(walls)])
    k = _same(plan_lanes, j_sch.plan_lanes, n_devices, demands, slots,
              max_lanes, size_wall=wall)
    if k is not None:
        assert 1 <= k <= max(1, min(len(demands), n_devices, max_lanes))


# -- hypothesis runs ----------------------------------------------------------

if HAVE_HYPOTHESIS:

    @settings(max_examples=60, deadline=None)
    @given(group_sizes=st.lists(st.integers(1, 9), min_size=1, max_size=10))
    def test_partition_matches_the_reference_property(group_sizes):
        check_partition(group_sizes)

    @settings(max_examples=100, deadline=None)
    @given(n_devices=st.integers(0, 16),
           demands=st.lists(st.floats(-1.0, 1e3), min_size=0, max_size=10),
           slots=st.integers(0, 32),
           max_groups=st.one_of(st.none(), st.integers(0, 16)))
    def test_plan_groups_matches_the_reference_property(
            n_devices, demands, slots, max_groups):
        check_plan_groups(n_devices, demands, slots, max_groups)

    @settings(max_examples=100, deadline=None)
    @given(n_devices=st.integers(1, 16),
           demands=st.lists(st.floats(0.0, 1e3), min_size=0, max_size=10),
           slots=st.integers(1, 32), max_lanes=st.integers(0, 16),
           walls=st.one_of(st.none(), st.lists(st.floats(0.0, 1e3),
                                               min_size=1, max_size=5)))
    def test_plan_lanes_matches_the_reference_property(
            n_devices, demands, slots, max_lanes, walls):
        check_plan_lanes(n_devices, demands, slots, max_lanes, walls)


# -- seeded sweeps (always run; same checkers) ------------------------------

@pytest.mark.parametrize("seed", range(10))
def test_partition_matches_the_reference_sweep(seed):
    rng = np.random.default_rng(seed)
    check_partition(rng.integers(1, 9, size=rng.integers(1, 10)).tolist())


@pytest.mark.parametrize("seed", range(12))
def test_plan_groups_matches_the_reference_sweep(seed):
    rng = np.random.default_rng(200 + seed)
    n_devices = int(rng.integers(1, 16))
    slots = int(rng.integers(1, 4)) * (1 << (n_devices - 1).bit_length())
    for _ in range(20):
        demands = (rng.random(rng.integers(1, 10)) * 10.0).tolist()
        max_groups = None if seed % 2 else int(rng.integers(1, 16))
        check_plan_groups(n_devices, demands, slots, max_groups)
        # slots the mesh does not divide, and a tie of demands
        check_plan_groups(n_devices, [1.0] * len(demands),
                          int(rng.integers(1, 24)), max_groups)


@pytest.mark.parametrize("seed", range(12))
def test_plan_lanes_matches_the_reference_sweep(seed):
    rng = np.random.default_rng(300 + seed)
    for _ in range(20):
        n_devices = int(rng.integers(1, 12))
        demands = (rng.random(rng.integers(1, 9)) * 5.0).tolist()
        walls = (None if rng.random() < 0.3
                 else (rng.random(4) * 5.0).tolist())
        check_plan_lanes(n_devices, demands, int(rng.integers(1, 16)),
                         int(rng.integers(1, 10)), walls)


@pytest.mark.parametrize("args", [
    (0, [1.0], 8, None), (8, [1.0], 0, None), (8, [], 8, None),
    (8, [1.0, -2.0], 8, None), (8, [1.0], 8, 0)])
def test_plan_groups_errors_match_the_reference(args):
    n, demands, slots, max_groups = args
    with pytest.raises(ValueError):
        plan_groups(n, demands, slots, max_groups=max_groups)
    _same(plan_groups, j_sch.plan_groups, n, demands, slots,
          max_groups=max_groups)


@pytest.mark.parametrize("args", [(4, [], 4, 4), (4, [1.0], 4, 0)])
def test_plan_lanes_errors_match_the_reference(args):
    with pytest.raises(ValueError):
        plan_lanes(*args)
    _same(plan_lanes, j_sch.plan_lanes, *args)


# -- the reference's pinned examples, inside the port -----------------------

def test_plan_groups_pinned_examples():
    """A lone wave takes the whole mesh, a heavy wave a wide group while
    light waves take one device each, equal demands split evenly, and
    ``max_groups=1`` is the one full-mesh group."""
    assert plan_groups(8, [1.0], 8) == [8]
    assert plan_groups(8, [10.0, .1, .1, .1, .1], 8) == [4, 1, 1, 1, 1]
    assert plan_groups(8, [1.0] * 5, 8) == [2, 2, 2, 1, 1]
    assert plan_groups(8, [1.0, 2.0, 3.0], 8, max_groups=1) == [8]
    assert plan_groups(4, [1.0] * 9, 8) == [1, 1, 1, 1]


def test_plan_groups_invalid_inputs_raise():
    with pytest.raises(ValueError, match="devices"):
        plan_groups(0, [1.0], 8)
    with pytest.raises(ValueError, match="slots"):
        plan_groups(8, [1.0], 0)
    with pytest.raises(ValueError, match="no demands"):
        plan_groups(8, [], 8)
    with pytest.raises(ValueError, match="negative"):
        plan_groups(8, [1.0, -2.0], 8)
    with pytest.raises(ValueError, match="max_groups"):
        plan_groups(8, [1.0], 8, max_groups=0)


def test_plan_lanes_pinned_examples():
    """Many light waves spread, a lone wave collapses to one group, and
    measured per-size walls steer the choice (narrow groups 10x slower:
    two waves share the wide one)."""
    assert plan_lanes(4, [1.0, 1.0, 1.0, 1.0], slots=4, max_lanes=4) == 4
    assert plan_lanes(4, [5.0], slots=4, max_lanes=4) == 1
    wall = {1: 10.0, 2: 1.0}
    assert plan_lanes(2, [1.0, 1.0], slots=2, max_lanes=2,
                      size_wall=lambda s: wall[s]) == 1
    assert plan_lanes(2, [1.0, 1.0], slots=2, max_lanes=2) == 2
    with pytest.raises(ValueError):
        plan_lanes(4, [], slots=4, max_lanes=4)
    with pytest.raises(ValueError):
        plan_lanes(4, [1.0], slots=4, max_lanes=0)


# -- the mesh helpers ---------------------------------------------------------

def test_partition_mesh_validates_axis_and_keeps_devices():
    with pytest.raises(ValueError, match="cores") as got:
        sharding.partition_mesh(sharding.CoresMesh(
            (torch.device("cpu"),), axis_names=("notcores",)), [1])
    assert str(got.value) == ("partition_mesh needs a 1-D 'cores' mesh, "
                              "got ('notcores',)")
    [sub] = sharding.partition_mesh(sharding.cores_mesh(1, device="cpu"), [1])
    assert sub.size == 1 and sub.axis_names == (sharding.CORES_AXIS,)
    mesh = sharding.CoresMesh(tuple(torch.device("cpu") for _ in range(8)))
    subs = sharding.partition_mesh(mesh, [4, 2, 1, 1])
    assert [s.size for s in subs] == [4, 2, 1, 1]
    assert sum((s.devices for s in subs), ()) == mesh.devices
    with pytest.raises(ValueError, match="sum"):
        sharding.partition_mesh(mesh, [4, 2])


def test_abstract_cores_mesh_shape():
    am = sharding.abstract_cores_mesh(4)
    assert am.size == 4 and am.axis_names == (sharding.CORES_AXIS,)
    assert am == sharding.abstract_cores_mesh(4) != \
        sharding.abstract_cores_mesh(2)
    with pytest.raises(ValueError):
        sharding.abstract_cores_mesh(0)


@pytest.mark.parametrize("slots,lanes", [(8, 1), (8, 2), (8, 4), (8, 8),
                                         (12, 3), (6, 4), (4, 0)])
def test_wave_slices_split_the_slots_evenly(slots, lanes):
    """Lane d owns [d*B/D, (d+1)*B/D); an uneven split raises with the
    reference runtime's text."""
    if lanes < 1 or slots % lanes:
        with pytest.raises(ValueError, match="not divisible"):
            sharding.wave_slices(slots, lanes)
        return
    got = sharding.wave_slices(slots, lanes)
    per = slots // lanes
    assert [(s.start, s.stop) for s in got] == [
        (d * per, (d + 1) * per) for d in range(lanes)]


def test_shard_wave_places_each_lane_range():
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 3, 2)
    mesh = sharding.cores_mesh(4, device="cpu")
    parts = sharding.shard_wave({"H0": x}, mesh)
    assert len(parts) == 4
    for d, part in enumerate(parts):
        assert torch.equal(part["H0"], x[2 * d: 2 * d + 2])
        # a stack already on the lane's device is a view, not a copy
        assert part["H0"].data_ptr() == x[2 * d].data_ptr()
