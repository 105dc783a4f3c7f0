"""Multi-pod dry run: every (arch x shape x mesh) cell, traced on ``meta``.

The JAX package lowers and compiles each cell's step on 256 or 512 forced
host devices and reads XLA's memory and cost analyses.  The port has no
partitioner and no compiler: it runs each cell's eager step once on
``meta`` tensors (shapes and dtypes, no memory, no card) under
``runtime/hlo_analysis.py::step_cost``, and reads the per-device numbers
from the shardings that ``runtime/sharding.py`` gives the production
meshes (``launch/mesh.py::make_production_mesh``: 16x16 single pod,
2x16x16 two pods).  Each number of a cell's JSON says what it rests on:

  argument bytes  exact: the sum over state and batch of each leaf's
                  ``NamedSharding.shard_shape`` bytes, a leaf no op reads
                  left out (XLA prunes an unused jit argument)
  output bytes    the state (train) or cache (prefill, decode) shards,
                  aliased to the arguments as the JAX step donates them,
                  plus the other results whole (an upper bound)
  temp bytes      the peak live bytes of the step traced at one data
                  shard's batch (global_batch / data) with the model axis
                  unsplit: an upper bound
  FLOPs, bytes    the traced global step's dot FLOPs and operand/result
                  bytes over n_chips
  collectives     the cell's sharded step (``runtime/steps.py``: train,
                  prefill or decode on the mesh, the recipe's fsdp; with
                  ``--override pod_compress=true`` the cross-pod
                  compressed train step, which needs the multi mesh)
                  run once on ``meta`` in representative mode: one id
                  traced, every other id a virtual member of its groups
                  (``runtime/collectives.Representatives``), its
                  collectives' result bytes counted for every id
                  (``hlo_analysis.collective_terms``: the largest id's)

One trace at the global batch and one at the data shard's batch serve
both meshes (both have a data axis of 16): only the shardings differ.
The representative trace is each mesh's own.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \\
      --mesh both
  python -m repro_torch.launch.dryrun --all [--mesh both]

Each cell writes results/dryrun_torch/<arch>__<shape>__<mesh>.json;
re-runs skip cells whose JSON already exists (``--force`` redoes them).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, cells, get_config, \
    get_recipe
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import collectives as col
from repro_torch.runtime import hlo_analysis as hlo
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as steps_lib

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")

FLOPS_BASIS = "global/n_chips"
TEMP_BASIS = "one data shard, model axis unsplit"


def n_params(cfg) -> tuple:
    """(total, active) parameter counts from the parameter spec."""
    leaves = []
    tfm.tree_map(leaves.append, tfm.param_spec(cfg))
    total = sum(int(np.prod(leaf.shape)) for leaf in leaves)
    active = total
    if cfg.n_experts:
        # active = total - (dormant experts): top_k of n_experts used/token
        per_expert = 3 * cfg.d_model * cfg.d_ff
        moe_layers = cfg.n_layers
        dormant = moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
        active = total - dormant
    return total, active


def _pairs(values, shardings):
    """(tensor, NamedSharding) of two trees of one structure."""
    if values is None:
        return
    if isinstance(values, dict):
        for k, v in values.items():
            yield from _pairs(v, shardings[k])
    elif isinstance(values, (list, tuple)):
        for v, s in zip(values, shardings):
            yield from _pairs(v, s)
    else:
        yield values, shardings


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


#: the last (arch, shape)'s traces, by batch: both meshes reuse them
_TRACES: Dict[Any, dict] = {}


def trace_step(cfg, shape, batch: int, *,
               moment_dtype=torch.float32) -> dict:
    """The cell's step at ``batch`` traced once on ``meta``: {"cost",
    "state" (train: the TrainState; serve: (params, cache)), "batch",
    "out" (the step's result), "seconds"}."""
    key = (cfg, tuple(shape), batch, str(moment_dtype))
    if key in _TRACES:
        return _TRACES[key]
    for old in [k for k in _TRACES if k[:2] != key[:2]]:
        del _TRACES[old]
    t0 = time.perf_counter()
    if shape.mode == "train":
        bundle = steps_lib.make_train_step(
            cfg, seq_len=shape.seq_len, global_batch=batch,
            moment_dtype=moment_dtype, device="meta")
        state = bundle.abstract_state
        out, cost = hlo.step_cost(bundle.fn, state, bundle.abstract_batch)
    else:
        make = (steps_lib.make_prefill_step if shape.mode == "prefill"
                else steps_lib.make_decode_step)
        bundle = make(cfg, seq_len=shape.seq_len, global_batch=batch)
        state = bundle.abstract_state
        params, cache = state
        # a live model casts each weight in the step, from the parameter
        # it reads (an unread one, as the audio encoder's in decode, is
        # no argument of the step)
        model = tfm.Transformer(cfg, params, live=True)

        def serve(params, cache, batch):
            with torch.no_grad():
                return bundle.fn(model, cache, batch)

        out, cost = hlo.step_cost(serve, params, cache, bundle.abstract_batch)
    rec = {"cost": cost, "state": state, "batch": bundle.abstract_batch,
           "out": out, "seconds": time.perf_counter() - t0}
    _TRACES[key] = rec
    return rec


def shard_batch(global_batch: int, mesh) -> int:
    """One data shard's batch: global_batch / the mesh's data axis (the
    whole batch where it does not divide)."""
    data = mesh.shape.get("data", 1)
    return global_batch // data if global_batch % data == 0 \
        else global_batch


def _shardings(cfg, mesh, rules, mode: str):
    """(state shardings, batch shardings) of a cell's step."""
    batch_sh = shd.batch_sharding(
        mesh, rules, with_memory=cfg.family in ("vlm", "audio"), mode=mode)
    if mode == "train":
        return steps_lib.state_shardings(cfg, mesh, rules), batch_sh
    return (shd.sharding_tree(tfm.param_axes(cfg), mesh, rules),
            shd.sharding_tree(tfm.cache_axes(cfg), mesh, rules)), batch_sh


def _argument_bytes(cfg, recipe, shape, mesh, glob) -> tuple:
    """(argument bytes a device holds, the donated state's or cache's part
    of them, the step's other results) of a traced step ``glob`` on
    ``mesh``: shard bytes of the leaves the step reads."""
    seq_shard = shape.mode != "train" and shape.global_batch < int(np.prod(
        [mesh.shape[a] for a in shd.dp_axes(mesh)]))
    rules = shd.make_rules(mesh, cfg, fsdp=recipe["fsdp"],
                           seq_shard=seq_shard,
                           global_batch=shape.global_batch)
    state_sh, batch_sh = _shardings(cfg, mesh, rules, shape.mode)
    reads = glob["cost"]["reads"]

    def shard_bytes(values, shardings) -> int:
        return sum(s.shard_nbytes(t) for t, s in _pairs(values, shardings)
                   if hlo.storage_key(t) in reads)

    state_b = shard_bytes(glob["state"], state_sh)
    argument = state_b + shard_bytes(glob["batch"], batch_sh)
    if shape.mode == "train":
        return argument, state_b, glob["out"][1]     # the metrics
    return (argument, shard_bytes(glob["state"][1], state_sh[1]),
            glob["out"][0])                          # the logits


def argument_bytes(cfg, recipe, shape, mesh) -> int:
    """A device's argument bytes of the cell (``analyze``'s
    ``argument_size_in_bytes``), from the global trace alone."""
    glob = trace_step(cfg, shape, shape.global_batch,
                      moment_dtype=recipe["moment_dtype"])
    return _argument_bytes(cfg, recipe, shape, mesh, glob)[0]


def collective_count(cfg, recipe, shape, mesh, *,
                     pod_compress: bool = False, batch=None, **step_kw):
    """The cell's sharded step on ``mesh`` (its ids copied onto ``meta``)
    run once in representative mode (``collectives.Representatives``):
    the step's ``collectives.Counter``.  ``pod_compress``: the cross-pod
    compressed train step, which needs a "pod" axis (the JAX step's
    assertion otherwise).  ``batch``: a host batch whose shapes and
    dtypes the step is called on (None: ``bundle.abstract_batch``);
    ``step_kw``: further keywords of the step's maker.  A mesh of one id
    has no group of two: its count is empty, and nothing is traced."""
    if pod_compress and "pod" not in mesh.axis_names:
        raise AssertionError("multi-pod mesh required")
    if mesh.size == 1:
        return col.Counter()
    kw = dict(seq_len=shape.seq_len, global_batch=shape.global_batch,
              fsdp=recipe["fsdp"], representative=True, **step_kw)
    mesh = Mesh(mesh.device_ids, mesh.axis_names,       # its ids on meta
                {int(i): torch.device("meta")
                 for i in mesh.device_ids.ravel()})
    if shape.mode == "train":
        make = (steps_lib.make_pod_compressed_train_step if pod_compress
                else steps_lib.make_train_step)
        bundle = make(cfg, mesh, moment_dtype=recipe["moment_dtype"], **kw)
    else:
        make = (steps_lib.make_prefill_step if shape.mode == "prefill"
                else steps_lib.make_decode_step)
        bundle = make(cfg, mesh, **kw)
    if batch is None:
        batch = bundle.abstract_batch
    else:
        batch = {k: v if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                 for k, v in batch.items()}
    state = steps_lib.placed_abstract(bundle)
    bundle.fn(*(state if shape.mode != "train" else (state,)), batch)
    return bundle.collectives


def analyze(cfg, recipe, shape, mesh, *,
            pod_compress: bool = False) -> dict:
    """One cell's numbers: ``cfg`` with its recipe (fsdp, moment_dtype)
    at ``shape`` (a ``configs.shapes.Shape``) on ``mesh``; the JSON of
    ``run_cell`` without the names of arch, shape and mesh."""
    n_chips = mesh.size
    t0 = time.perf_counter()
    coll = collective_count(cfg, recipe, shape, mesh,
                            pod_compress=pod_compress)
    coll_s = time.perf_counter() - t0
    glob = trace_step(cfg, shape, shape.global_batch,
                      moment_dtype=recipe["moment_dtype"])
    temp_batch = shard_batch(shape.global_batch, mesh)
    part = trace_step(cfg, shape, temp_batch,
                      moment_dtype=recipe["moment_dtype"])

    argument, donated, rest = _argument_bytes(cfg, recipe, shape, mesh,
                                              glob)
    mem = hlo.memory_summary(argument=argument,
                             output=donated + _nbytes(rest),
                             temp=part["cost"]["temp_bytes"], alias=donated)
    terms = hlo.roofline_terms(glob["cost"], n_chips=n_chips,
                               collectives=coll)
    total_p, active_p = n_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    mflops = hlo.model_flops(active_p, tokens,
                             "train" if shape.mode == "train" else "serve")
    mflops_per_chip = mflops / n_chips
    useful = (mflops_per_chip / terms["hlo_flops"]
              if terms["hlo_flops"] else float("nan"))
    return {
        "mode": shape.mode, "n_chips": n_chips,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "fsdp": recipe["fsdp"],
        "moment_dtype": str(recipe["moment_dtype"]).replace("torch.", ""),
        "params_total": total_p, "params_active": active_p,
        "lower_s": round(glob["seconds"], 1),
        "compile_s": round(part["seconds"], 1),
        "collective_trace_s": round(coll_s, 1),
        "memory": mem,
        "hbm_gb_per_chip": round(mem["per_device_bytes"] / 2**30, 3),
        "roofline": terms,
        "model_flops_per_chip": mflops_per_chip,
        "useful_flop_frac": useful,
        "flops_basis": FLOPS_BASIS,
        "temp_basis": TEMP_BASIS,
        "temp_batch": temp_batch,
        "basis": {
            "argument": "exact: shard_shape bytes of the state and batch "
                        "leaves the step reads",
            "output": "state/cache shards (aliased, donated) + the other "
                      "results whole",
            "temp": f"peak live bytes at batch {temp_batch} "
                    f"({TEMP_BASIS}): an upper bound",
            "flops": "traced global dot FLOPs / n_chips",
            "bytes": "traced global operand+result bytes / n_chips",
            "lower_s": "seconds of the global meta trace",
            "compile_s": "seconds of the data shard's meta trace",
            "collectives": "the sharded "
                           + ("pod-compressed train" if pod_compress
                              else shape.mode)
                           + " step traced on meta for one id of the mesh, "
                             "every id counted as that id (runtime/"
                             "collectives.Representatives); per device the "
                             "largest id's result bytes, an all-reduce "
                             "twice, over NVLink's 450 GB/s a direction",
        },
        "trace": {"ops": glob["cost"]["ops"],
                  "op_counts": glob["cost"]["op_counts"],
                  "flops_by_op": glob["cost"]["flops_by_op"]},
        "divisibility": shd.check_divisibility(cfg, mesh, shape.global_batch,
                                               shape.mode),
        "hbm_card_bytes": hlo.HBM_BYTES,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             overrides: Optional[dict] = None) -> dict:
    cfg = get_config(arch)
    recipe = get_recipe(arch)
    if overrides:
        recipe.update({k: v for k, v in overrides.items()
                       if k in ("fsdp",)})
        overrides = dict(overrides)
        cfg_over = {k: v for k, v in overrides.items()
                    if k in ("attn_chunk", "moe_group", "attn_impl",
                             "remat_block", "attn_skip", "loss_chunk")}
        if cfg_over:
            cfg = cfg.replace(**cfg_over)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    pod_compress = bool(overrides and overrides.get("pod_compress")
                        and shape.mode == "train")
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            **analyze(cfg, recipe, shape, mesh, pod_compress=pod_compress),
            "overrides": overrides or {}}


def _fmt(x) -> str:
    return "n/a" if x is None else f"{x:.2e}s"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for result files "
                    "(perf experiments)")
    ap.add_argument("--override", default="", help="k=v[,k=v] cfg overrides")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        overrides[k] = (v == "true") if v in ("true", "false") else (
            v if not v.lstrip("-").isdigit() else int(v))

    RESULTS.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        run, skip = cells(ARCH_NAMES)
        jobs = [(a, s, m) for (a, s) in run for m in meshes]
        for a, s, why in skip:
            print(f"SKIP {a} {s}: {why}")
    else:
        assert args.arch and args.shape
        jobs = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape, mesh_kind in jobs:
        tag = f"__{args.tag}" if args.tag else ""
        path = RESULTS / f"{arch}__{shape}__{mesh_kind}{tag}.json"
        if path.exists() and not args.force:
            print(f"CACHED {path.name}")
            continue
        try:
            res = run_cell(arch, shape, mesh_kind, overrides or None)
            path.write_text(json.dumps(res, indent=1))
            r = res["roofline"]
            print(f"OK {arch} {shape} {mesh_kind}: "
                  f"hbm={res['hbm_gb_per_chip']}GiB "
                  f"compute={_fmt(r['compute_s'])} "
                  f"mem={_fmt(r['memory_s'])} "
                  f"coll={_fmt(r['collective_s'])} dom={r['dominant']} "
                  f"(trace {res['lower_s']}s + {res['compile_s']}s + "
                  f"{res.get('collective_trace_s', 'n/a')}s)",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — record the failure, continue
            failures += 1
            print(f"FAIL {arch} {shape} {mesh_kind}: {e}", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
