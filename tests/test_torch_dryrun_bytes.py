"""The dry run's per-device argument bytes and collective bytes against
XLA's: the JAX train and decode steps of the 10 smoke configs compiled on
8 forced host devices at a (data 2, model 4) mesh, and the train steps of
the five configs whose recipe has fsdp off at (data 8, model 1) (one
subprocess).

Argument bytes: each ``memory_analysis().argument_size_in_bytes``
against ``launch/dryrun.py::analyze``'s ``argument_size_in_bytes`` on an
abstract mesh of that shape, fsdp as each recipe says.  No pair differs:
an input no op reads is no argument of either step (XLA prunes it; the
port's trace sees no read), which is what makes mamba2's decode (its
positions: an SSD layer has no RoPE) and seamless's decode (the
encoder's weights: the memory comes encoded) agree.  The same subprocess
gives JAX's ``NamedSharding.shard_shape`` and its refusal of a split
that does not divide, for the port's to be held to.

Collective bytes: XLA's loop-aware walk of each compiled program
(``loop_aware_analysis``: result bytes, an all-reduce twice) against the
port's representative count of its sharded step
(``dryrun.collective_count``, ``hlo_analysis.collective_terms``).  On the
data-only mesh, where each step's collectives are the gradients' sums and
the loss's, the two agree within ``DATA_ONLY_TOL`` bytes (the port's count
is 16 B above XLA's in each of the five); with a model axis the
programs part (XLA's GSPMD partitioner picks its own collectives,
``PERF.md`` §6), so there both counts are printed by kind, side by side,
not gated.
"""
import numpy as np
import pytest
import torch

from conftest import run_in_mesh_subprocess
from repro.configs import ARCH_NAMES
from repro_torch.configs import get_config, get_recipe
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, process_devices
from repro_torch.runtime import hlo_analysis as hlo
from repro_torch.runtime import sharding as tsh

SEQ, BATCH = 32, 8
#: bytes the port's collective count may differ from XLA's on (8, 1)
DATA_ONLY_TOL = 64
#: the configs whose recipe has fsdp off
NO_FSDP = [a for a in ARCH_NAMES if not get_recipe(a)["fsdp"]]
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
from repro.runtime.hlo_analysis import loop_aware_analysis
mesh = jax.make_mesh((2, 4), ("data", "model"))
data_only = jax.make_mesh((8, 1), ("data", "model"))
out = {{"args": {{}}, "shard": [], "coll": {{}}}}
lowered = {{}}
for arch in ARCH_NAMES:
    cfg = get_config(arch, smoke=True)
    fsdp = get_recipe(arch)["fsdp"]
    cells = [("train", mesh, ""), ("decode", mesh, "")]
    if not fsdp:
        cells.append(("train", data_only, "@8x1"))
    for mode, m, tag in cells:
        make = steps.make_train_step if mode == "train" else \\
            steps.make_decode_step
        b = make(cfg, m, seq_len={SEQ}, global_batch={BATCH}, fsdp=fsdp)
        state = (b.abstract_state,) if mode == "train" else \\
            tuple(b.abstract_state)
        with m:
            lowered[f"{{arch}}/{{mode}}{{tag}}"] = b.fn.lower(
                *state, b.abstract_batch)
with ThreadPoolExecutor(4) as pool:
    compiled = dict(zip(lowered, pool.map(lambda lo: lo.compile(),
                                          lowered.values())))
for key, c in compiled.items():
    out["args"][key] = c.memory_analysis().argument_size_in_bytes
    la = loop_aware_analysis(c.as_text())
    out["coll"][key] = {{"bytes": la["collective_bytes"],
                        "by_kind": la["by_kind"], "counts": la["counts"],
                        "by_group": by_group(c.as_text())
                        if "@" not in key else {{}}}}
for spec, shape in {SHARD_CASES!r}:
    try:
        got = list(NamedSharding(mesh, P(*spec)).shard_shape(shape))
    except ValueError as e:
        got = str(e)
    out["shard"].append(got)
print(json.dumps(out))
"""


#: XLA's collectives of a compiled (2, 4) program by kind and by the mesh
#: axis their replica groups span ("model" rows of 4, "model pairs"
#: inside a row, "data" columns, "pairs" of a collective-permute), bytes
#: through the loop-aware walk's trip counts (an all-reduce twice)
_GROUPS = r"""
import re
from collections import defaultdict
import numpy as np


def _members(spec):
    m = re.match(r"\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?",
                 spec)
    if m:
        dims = [int(x) for x in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(x) for x in m.group(4).split(",")])
        return ids.reshape(int(m.group(1)), int(m.group(2)))[0].tolist()
    return [int(x) for x in spec.strip("{}").split("},{")[0].split(",")]


def _axis(line, model=4):
    g = re.search(r"replica_groups=(\{\{[^ ]*\}\}|\[[\d,]+\]<=\[[\d,]+\]"
                  r"(?:T\([\d,]+\))?)", line)
    if not g:
        return "pairs"
    ids = _members(g.group(1))
    rows = {i // model for i in ids}
    cols = {i % model for i in ids}
    if len(rows) == 1:
        return "model" if len(cols) == model else "model pairs"
    return "data" if len(cols) == 1 else "data,model"


def by_group(text):
    from repro.runtime import hlo_analysis as H
    comps = H._split_computations(text)
    called = set()
    for lines in comps.values():
        for line in lines:
            for rx in (H._CALLS_RE, H._BODY_RE, H._COND_RE):
                called.update(m.group(1) for m in rx.finditer(line))
    mult = defaultdict(float)

    def walk(comp, k):
        mult[comp] += k
        for line in comps.get(comp, []):
            p = H._parse_op(line)
            if p and p[2] == "while":
                body, cond = H._BODY_RE.search(line), H._COND_RE.search(line)
                trip = H._trip_count(comps.get(cond.group(1), [])) if cond \
                    else 1
                if body:
                    walk(body.group(1), k * trip)
            elif p and p[2] in ("fusion", "call"):
                cm = H._CALLS_RE.search(line)
                if cm:
                    walk(cm.group(1), k)

    for comp in comps:
        if comp not in called:
            walk(comp, 1.0)
    out = defaultdict(float)
    for comp, lines in comps.items():
        for line in lines:
            p = H._parse_op(line)
            if not p or p[2].endswith("-start"):
                continue
            base = p[2].replace("-done", "")
            if base in H._COLLECTIVES and mult[comp]:
                b = H._shape_bytes(p[1]) * mult[comp]
                out[f"{base} {_axis(line)}"] += b * (2 if base ==
                                                     "all-reduce" else 1)
    return dict(out)
"""


@pytest.fixture(scope="module")
def xla():
    return run_in_mesh_subprocess(_GROUPS + _SCRIPT, devices=8)


def _mesh(shape=(2, 4)):
    return Mesh(np.arange(8).reshape(shape), ("data", "model"),
                process_devices("meta", 8))


def _port_terms(arch, mode, shape=(2, 4)):
    """The port's collective terms of the smoke step on ``shape``, and its
    bytes by (kind, axes) on id 0 (an all-reduce twice)."""
    recipe = dict(get_recipe(arch), moment_dtype=torch.float32)
    counter = dryrun.collective_count(
        get_config(arch, smoke=True), recipe,
        Shape("smoke", SEQ, BATCH, mode), _mesh(shape))
    terms = hlo.collective_terms(counter)
    terms["by_axes"] = {f"{kind} {axes}": b * (2 if kind == "all-reduce"
                                               else 1)
                        for kind, per in counter.by_id().get(0, {}).items()
                        for axes, b in per.items()}
    return terms


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


@pytest.mark.parametrize("arch", NO_FSDP)
def test_data_only_collective_bytes_are_xla_s(xla, arch):
    got = _port_terms(arch, "train", (8, 1))
    want = xla["coll"][f"{arch}/train@8x1"]
    print(f"{arch} train (8, 1): port {got['collective_bytes']} B "
          f"{got['collective_by_kind']}, XLA {want['bytes']:.0f} B "
          f"{want['by_kind']}")
    assert abs(got["collective_bytes"] - want["bytes"]) <= DATA_ONLY_TOL


@pytest.mark.parametrize("mode", ("train", "decode"))
def test_collective_bytes_by_kind_beside_xla_s(xla, mode):
    """At (2, 4) the two programs' collectives are printed by kind (bytes,
    then ops) for the 10 configs; both count some."""
    rows = []
    for arch in ARCH_NAMES:
        got = _port_terms(arch, mode)
        want = xla["coll"][f"{arch}/{mode}"]
        kinds = [k for k in hlo.COLLECTIVES
                 if got["collective_by_kind"][k] or want["by_kind"][k]]
        rows.append(f"{arch} {mode} (2, 4): port {got['collective_bytes']} "
                    f"B, XLA {want['bytes']:.0f} B; " + ", ".join(
                        f"{k} {got['collective_by_kind'][k]} / "
                        f"{want['by_kind'][k]:.0f} B "
                        f"({got['collective_counts'][k]} / "
                        f"{want['counts'][k]} ops)" for k in kinds)
                    + "; XLA by group: " + ", ".join(
                        f"{k} {v:.0f}" for k, v in sorted(
                            want["by_group"].items(), key=lambda kv: -kv[1]))
                    + f"; port by axes: {got['by_axes']}")
        assert sum(want["by_group"].values()) == want["bytes"]
        assert want["bytes"] > 0 and (got["collective_bytes"] > 0
                                      or mode == "decode")
    print("\n".join(rows))
