"""The port's fleet placement (``repro_torch.runtime.sharding``,
``repro_torch.launch.mesh``) against the JAX package's.

``assign_buckets`` is pure logic and must equal the JAX function on every
input; ``BucketPlacement``'s quantum and errors, ``matrix_batch_sharding``'s
axis choice (against the JAX ``PartitionSpec`` on an abstract mesh of the
same shape), ``make_local_mesh``'s errors and the placement manifests
(against ``fleet_placement(...).manifest()`` on 8 forced host devices, one
subprocess) must equal the JAX package's too.  The port's 8 devices are
logical CPU devices (``logical_devices``)."""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from conftest import run_in_mesh_subprocess
from repro.launch import mesh as jmesh
from repro.runtime import sharding as jsh
from repro_torch.launch.mesh import (Mesh, logical_devices,
                                     make_local_mesh, process_devices)
from repro_torch.runtime import sharding as tsh

#: (bucket sizes, weights) cases: more buckets than devices, saturated
#: buckets (fewer graphs than the devices they would get), weights that
#: favour the wide bucket, a single bucket
BUCKETS = {
    "even": ({16: 4, 32: 4}, None),
    "weighted": ({16: 5, 32: 3, 64: 2},
                 {16: 5 * 16 * 4.0, 32: 3 * 32 * 5.0, 64: 2 * 64 * 6.0}),
    "saturated": ({8: 1, 16: 2, 32: 1}, None),
    "one": ({"all": 64}, None),
    "many": ({w: 3 for w in (8, 16, 32, 64, 128)}, None),
    "ragged": ({64: 21, 128: 22, 256: 21},
               {64: 21 * 64 * 6.0, 128: 22 * 128 * 7.0, 256: 21 * 256 * 8.0}),
}
DEVICE_COUNTS = (1, 2, 3, 4, 8, 16)


@pytest.mark.parametrize("case", sorted(BUCKETS))
@pytest.mark.parametrize("devices", DEVICE_COUNTS)
def test_assign_buckets_is_the_jax_function(devices, case):
    sizes, weights = BUCKETS[case]
    got = tsh.assign_buckets(devices, sizes, weights)
    assert got == jsh.assign_buckets(devices, sizes, weights)
    if len(sizes) > devices:            # round-robin sharing
        assert all(len(v) == 1 for v in got.values())
    else:                               # disjoint, within each bucket's cap
        used = [i for v in got.values() for i in v]
        assert len(used) == len(set(used))
        assert all(len(got[k]) <= max(sizes[k], 1) for k in sizes)


@pytest.mark.parametrize("args", [(0, {8: 1}), (2, {8: 0, 16: 2}),
                                  (-1, {8: 1})])
def test_assign_buckets_errors_are_the_jax_errors(args):
    with pytest.raises(ValueError) as want:
        jsh.assign_buckets(*args)
    with pytest.raises(ValueError) as got:
        tsh.assign_buckets(*args)
    assert str(got.value) == str(want.value)
    assert tsh.assign_buckets(4, {}) == jsh.assign_buckets(4, {}) == {}


@pytest.mark.parametrize("ids,batch", [((0,), 5), ((0, 1), 5),
                                       ((0, 1, 2), 64), ((3, 4, 5, 6), 64),
                                       ((0, 1, 2, 3), 3)])
def test_bucket_placement_quantum(ids, batch):
    got, want = tsh.BucketPlacement(ids, batch), jsh.BucketPlacement(ids,
                                                                     batch)
    assert (got.num_devices, got.batch_padded) == (want.num_devices,
                                                   want.batch_padded)
    assert got.rows * got.num_devices == got.batch_padded
    assert hash(got) == hash(tsh.BucketPlacement(list(ids), batch))


@pytest.mark.parametrize("ids,batch", [((), 4), ((0,), 0), ((0, 1), -2)])
def test_bucket_placement_errors_are_the_jax_errors(ids, batch):
    with pytest.raises(ValueError) as want:
        jsh.BucketPlacement(ids, batch)
    with pytest.raises(ValueError) as got:
        tsh.BucketPlacement(ids, batch)
    assert str(got.value) == str(want.value)


def test_place_pads_splits_and_gathers():
    with logical_devices(3, "cpu"):
        mesh = make_local_mesh(device="cpu")
    pl = tsh.single_bucket_placement(mesh, 7)
    assert pl.batch_padded == 9 and pl.devices == ("cpu",) * 3
    x = torch.arange(7 * 2, dtype=torch.float32).reshape(7, 2)
    shards = pl.place(x)
    assert [tuple(s.shape) for s in shards] == [(3, 2)] * 3
    assert all(s.is_contiguous() for s in shards)
    # every shard owns its memory, also on the array's own device
    assert len({s.data_ptr() for s in shards} | {x.data_ptr()}) == 4
    assert torch.equal(shards[2][1:], torch.zeros(2, 2))
    assert torch.equal(pl.crop(pl.gather(shards)), x)
    with pytest.raises(ValueError, match="exceeds batch_padded=9"):
        pl.place(torch.zeros(10, 2))
    with pytest.raises(ValueError, match="!= batch_padded=9"):
        pl.place_leaf(x)
    # a placement built by hand resolves its ids through the process's
    # CUDA devices, with the JAX package's message when they are missing
    bare = tsh.BucketPlacement((0, 5), 4)
    if torch.cuda.device_count() < 6:
        with pytest.raises(ValueError, match=r"placement names device ids "
                           r"\[.*5\] but this process has"):
            bare.torch_devices()


#: (pod, data) mesh shapes and batch sizes for matrix_batch_sharding
GRID = [((4, 2), b) for b in (1, 2, 4, 6, 8, 12, 16)] + \
       [((2, 4), b) for b in (2, 4, 6, 8)] + \
       [((3, 2), b) for b in (2, 3, 6, 9)] + [((1, 8), b) for b in (4, 8)]


@pytest.mark.parametrize("shape,batch", GRID)
def test_matrix_batch_sharding_picks_the_jax_axes(shape, batch):
    axes = ("pod", "data")
    want = jsh.matrix_batch_sharding(AbstractMesh(shape, axes), 3,
                                     batch=batch).spec
    first = want[0]
    if isinstance(first, str):
        first = (first,)
    tmesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes,
                 {i: torch.device("cpu") for i in range(int(np.prod(shape)))})
    got = tsh.matrix_batch_sharding(tmesh, 3, batch=batch)
    assert got.axes == first
    assert got.shards == (1 if first is None else
                          int(np.prod([tmesh.shape[a] for a in first])))
    assert batch % got.shards == 0
    assert len(tsh.batch_shard_ids(tmesh, batch)) == got.shards
    # no batch: every data axis
    assert tsh.matrix_batch_sharding(tmesh, 3).axes == axes
    assert tuple(tsh.dp_axes(tmesh)) == axes


@pytest.mark.parametrize("model_axis", [0, 2, 3, -1])
def test_make_local_mesh_errors_are_the_jax_errors(model_axis):
    """Both processes see one device here (the JAX process one CPU, the
    port the CPU), so the messages match word for word."""
    with pytest.raises(ValueError) as want:
        jmesh.make_local_mesh(model_axis)
    with pytest.raises(ValueError) as got:
        make_local_mesh(model_axis, device="cpu")
    assert str(got.value) == str(want.value)


def test_make_local_mesh_over_logical_devices():
    assert process_devices("cpu") == {0: torch.device("cpu")}
    with logical_devices(8, "cpu"):
        m = make_local_mesh(2, device="cpu")
        assert len(process_devices("cpu")) == 8
    assert dict(m.shape) == {"data": 4, "model": 2}
    assert m.devices() == [torch.device("cpu")] * 8
    assert tsh.data_devices(m) == [0, 2, 4, 6]
    assert len(process_devices("cpu")) == 1     # the block has ended
    with pytest.raises(ValueError, match="count must be >= 1"):
        with logical_devices(0):
            pass


_MANIFEST_SCRIPT = """
    import json
    from repro.launch.mesh import make_local_mesh
    from repro.runtime.sharding import fleet_placement, single_bucket_placement
    CASES = %r
    mesh = make_local_mesh()
    out = {}
    for name, (sizes, weights) in CASES.items():
        sizes = {int(k) if k.isdigit() else k: v for k, v in sizes.items()}
        if weights is not None:
            weights = {int(k) if k.isdigit() else k: v
                       for k, v in weights.items()}
        out[name] = fleet_placement(mesh, sizes, weights).manifest()
    one = single_bucket_placement(mesh, 13)
    out["single"] = [list(one.device_ids), one.batch, one.batch_padded]
    print(json.dumps(out))
"""


def _jsonable(case):
    sizes, weights = case
    return ({str(k): v for k, v in sizes.items()},
            None if weights is None else {str(k): v
                                          for k, v in weights.items()})


@pytest.fixture(scope="module")
def jax_manifests():
    cases = {name: _jsonable(c) for name, c in BUCKETS.items()}
    return run_in_mesh_subprocess(_MANIFEST_SCRIPT % (cases,), devices=8)


@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_fleet_manifest_is_the_jax_manifest(jax_manifests, case):
    sizes, weights = BUCKETS[case]
    with logical_devices(8, "cpu"):
        mesh = make_local_mesh(device="cpu")
    fp = tsh.fleet_placement(mesh, sizes, weights)
    assert fp.manifest() == jax_manifests[case]
    assert fp.num_devices == 8
    for key, p in fp.items():
        assert key in fp and fp[key] is p
        assert p.devices == ("cpu",) * p.num_devices
    one = tsh.single_bucket_placement(mesh, 13)
    assert [list(one.device_ids), one.batch, one.batch_padded] == \
        jax_manifests["single"]
