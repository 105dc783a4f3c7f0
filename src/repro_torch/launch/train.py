"""Training CLI: --arch config, synthetic data, checkpoint/restart and
a straggler watchdog, the JAX package's ``launch/train.py`` on one card or
a mesh of devices.

CPU smoke:   python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
                 --steps 6 --seq-len 32 --global-batch 4 --device cpu
Resume:      add --resume auto   (restores the newest committed checkpoint
             and replays the data stream from its step)

  * checkpoints every --ckpt-every steps and at the last step, written on
    a background thread in the JAX package's on-disk format, committed by
    a marker written last: a writer killed mid-write never corrupts a
    resume;
  * the data stream is a pure function of (seed, step), so a resume
    replays it exactly with no state to save;
  * per-step watchdog: a step slower than --straggler-factor x the
    rolling median is logged as a straggler.

The mesh: ``--model-axis k`` goes through ``launch/mesh.py::
make_local_mesh`` as in the JAX package's CLI, a ("data", "model") mesh
over every device of ``--device``'s kind the process has (an axis they
cannot hold raises its ``ValueError``).  On one device the step is the
unsharded one; on more it is the sharded step (``runtime/steps.py``:
data, tensor and expert parallelism for every ``--arch``, the state in
shards on the mesh's ids).  A
sharded run saves its state gathered into host memory (no device holds
it whole), in the same one-file format as an unsharded run, so the JAX
store and an unsharded port read it; ``--resume auto`` restores it into
host memory and places it on the reader's mesh, whatever device count
wrote it (the JAX CLI's elastic restart).  In the tests and the
smoke script the devices are logical ones of one card or the CPU
(``logical_devices``):

  with logical_devices(4, "cpu"):
      train.main(["--arch", "qwen2-1.5b", "--smoke", "--model-axis", "2",
                  "--device", "cpu", ...])

The default checkpoint directory is ``repro_torch_ckpt_<arch>`` under
the temporary directory, apart from the JAX package's.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config, get_recipe
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.runtime import steps as steps_lib
from repro_torch.runtime.sharding import gather_tree, place_tree


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=["no", "auto"], default="no")
    ap.add_argument("--grad-compress-ratio", type=float, default=0.0)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cpu)")
    return ap.parse_args(argv)


def _sync(devices) -> None:
    for device in set(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def run(args) -> dict:
    """The training loop of ``main``; returns {"final_loss", "state"
    (placed, mesh id -> its shards, on a mesh of several devices),
    "step_s" (each step's seconds), "save_s" (the last save's seconds from
    its call to its commit), "ckpt_dir", "start_step", "bundle",
    "mesh"}."""
    # the JAX driver's mesh: its ValueError when the devices cannot hold
    # the model axis
    mesh = make_local_mesh(args.model_axis, device=args.device)
    sharded = mesh.size > 1
    cfg = get_config(args.arch, smoke=args.smoke)
    recipe = get_recipe(args.arch)
    device = (mesh.device(int(mesh.device_ids.min())) if sharded
              else torch.device(args.device))
    print(f"arch={cfg.name} device={device} mesh={dict(mesh.shape)}")

    use_comp = args.grad_compress_ratio > 0
    bundle = steps_lib.make_train_step(
        cfg, mesh if sharded else None, seq_len=args.seq_len,
        global_batch=args.global_batch,
        fsdp=recipe["fsdp"] and not args.smoke,
        moment_dtype=recipe["moment_dtype"],
        peak_lr=args.peak_lr, warmup=args.warmup, total_steps=args.steps,
        grad_compress_ratio=args.grad_compress_ratio, device=device)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro_torch_ckpt_{cfg.name}")
    mgr = CheckpointManager(ckpt_dir, keep=2)

    def fresh():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        if sharded:
            return steps_lib.placed_train_state(bundle, gen)
        return steps_lib.concrete_train_state(
            cfg, gen, device, use_compression=use_comp,
            moment_dtype=recipe["moment_dtype"])

    start_step = 0
    if args.resume == "auto" and pathlib.Path(ckpt_dir).exists():
        try:
            # a sharded state comes through host memory, leaf by leaf
            # to its shards: no device holds it whole
            state, start_step, meta = mgr.restore_latest(
                bundle.abstract_state,
                map_location="cpu" if sharded else device)
            if sharded:
                state = place_tree(state, bundle.state_shardings)
            print(f"resumed from step {start_step} "
                  f"(saved on {meta.get('mesh', '?')} devices)")
        except FileNotFoundError:
            state = fresh()
    else:
        state = fresh()

    pipe = SyntheticLM(cfg, args.seq_len, args.global_batch, seed=args.seed)
    it = pipe.iterator(start_step=start_step)
    step_times = []
    metrics, t_save, save_s = None, None, None
    try:
        t_log = time.time()
        for step in range(start_step, args.steps):
            batch = next(it)
            t0 = time.time()
            state, metrics = bundle.fn(state, batch)
            _sync(mesh.devices() if sharded else [device])
            dt = time.time() - t0
            step_times.append(dt)
            med = float(np.median(step_times[-50:]))
            if len(step_times) > 5 and dt > args.straggler_factor * med:
                print(f"[watchdog] step {step} straggled: {dt:.2f}s "
                      f"vs median {med:.2f}s")
            if (step + 1) % args.log_every == 0:
                tok_s = (args.global_batch * args.seq_len
                         * args.log_every / (time.time() - t_log))
                print(f"step {step + 1:5d} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} tok/s={tok_s:,.0f}")
                t_log = time.time()
            if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                t_save = time.time()
                whole = (gather_tree(state, bundle.state_shardings,
                                     host=True)
                         if sharded else state)
                mgr.save(step + 1, whole,
                         metadata={"mesh": mesh.size, "arch": cfg.name})
        mgr.wait()
        if t_save is not None:
            save_s = time.time() - t_save
    finally:
        it.close()
    final_loss = (float(metrics["loss"]) if metrics is not None
                  else float("nan"))
    print(json.dumps({"final_step": args.steps, "final_loss": final_loss}))
    return {"final_loss": final_loss, "state": state, "step_s": step_times,
            "save_s": save_s, "ckpt_dir": ckpt_dir,
            "start_step": start_step, "bundle": bundle, "mesh": mesh}


def main(argv=None):
    return run(parse_args(argv))["final_loss"]


if __name__ == "__main__":
    main()
