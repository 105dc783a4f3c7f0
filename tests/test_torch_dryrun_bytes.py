"""The dry run's per-device argument bytes against XLA's: the JAX train
and decode steps of the 10 smoke configs compiled on 8 forced host
devices at a (data 2, model 4) mesh (one subprocess), each
``memory_analysis().argument_size_in_bytes`` against
``launch/dryrun.py::analyze``'s ``argument_size_in_bytes`` on an abstract
mesh of that shape, fsdp as each recipe says.  No pair differs: an input
no op reads is no argument of either step (XLA prunes it; the port's
trace sees no read), which is what makes mamba2's decode (its positions:
an SSD layer has no RoPE) and seamless's decode (the encoder's weights:
the memory comes encoded) agree.  The same subprocess gives JAX's
``NamedSharding.shard_shape`` and its refusal of a split that does not
divide, for the port's to be held to."""
import numpy as np
import pytest
import torch

from conftest import run_in_mesh_subprocess
from repro.configs import ARCH_NAMES
from repro_torch.configs import get_config, get_recipe
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, process_devices
from repro_torch.runtime import sharding as tsh

SEQ, BATCH = 32, 8
#: (spec, global shape) cases of shard_shape, the last one uneven
SHARD_CASES = [(("data", None), (8, 6)), ((("data", "model"),), (16, 3)),
               ((None, "model"), (5, 12)), ((), (7,)),
               (("model",), (6, 3))]

_SCRIPT = f"""
import json
import os
from concurrent.futures import ThreadPoolExecutor
# the argument sizes are the partitioner's: no backend optimization needed
os.environ["XLA_FLAGS"] += " --xla_backend_optimization_level=0"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCH_NAMES, get_config, get_recipe
from repro.runtime import steps
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {{"args": {{}}, "shard": []}}
lowered = {{}}
for arch in ARCH_NAMES:
    cfg = get_config(arch, smoke=True)
    fsdp = get_recipe(arch)["fsdp"]
    for mode in ("train", "decode"):
        make = steps.make_train_step if mode == "train" else \\
            steps.make_decode_step
        b = make(cfg, mesh, seq_len={SEQ}, global_batch={BATCH}, fsdp=fsdp)
        state = (b.abstract_state,) if mode == "train" else \\
            tuple(b.abstract_state)
        with mesh:
            lowered[f"{{arch}}/{{mode}}"] = b.fn.lower(*state,
                                                      b.abstract_batch)
with ThreadPoolExecutor(4) as pool:
    compiled = dict(zip(lowered, pool.map(lambda lo: lo.compile(),
                                          lowered.values())))
for key, c in compiled.items():
    out["args"][key] = c.memory_analysis().argument_size_in_bytes
for spec, shape in {SHARD_CASES!r}:
    try:
        got = list(NamedSharding(mesh, P(*spec)).shard_shape(shape))
    except ValueError as e:
        got = str(e)
    out["shard"].append(got)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def xla():
    return run_in_mesh_subprocess(_SCRIPT, devices=8)


def _mesh():
    return Mesh(np.arange(8).reshape(2, 4), ("data", "model"),
                process_devices("meta", 8))


@pytest.mark.parametrize("mode", ("train", "decode"))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_argument_bytes_are_xla_s(xla, arch, mode):
    recipe = dict(get_recipe(arch), moment_dtype=torch.float32)
    got = dryrun.analyze(get_config(arch, smoke=True), recipe,
                         Shape("smoke", SEQ, BATCH, mode), _mesh())
    assert got["memory"]["argument_size_in_bytes"] == \
        xla["args"][f"{arch}/{mode}"]


@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_shard_shape_is_jax_s(xla, case):
    spec, shape = SHARD_CASES[case]
    want = xla["shard"][case]
    s = tsh.NamedSharding(_mesh(), tsh.P(*spec))
    if isinstance(want, str):           # JAX refuses an uneven split
        with pytest.raises(ValueError) as got:
            s.shard_shape(shape)
        tail = "implies that array axis"
        assert str(got.value)[str(got.value).index(tail):] == \
            want[want.index(tail):]
    else:
        assert list(s.shard_shape(shape)) == want
