"""Training CLI: `python -m cloud_server_tpu_torch.train`.

Config comes from a JSON file with optional sections {"model", "train",
"mesh", "loop"} (the reference's format), with common fields
overridable from the command line. Data is a flat binary token file
(`--data`, the `MemmapTokenDataset` format; several as a weighted
mixture) or `--synthetic N` random examples; `--eval-data` adds periodic
evaluation and `--checkpoint-dir` checkpoints with automatic resume.
The model family follows the config: MoE when model.num_experts >= 2.
`--lora-rank` trains rank-R adapters over a frozen base (random, or
`--init-from` a training checkpoint), writing the adapter config beside
the checkpoints. Runs on the GPU unless `--device cpu` is given.

A "mesh" section of more than one device trains over a
`torch.distributed` mesh, one process a rank: start the ranks with
`torchrun --nproc-per-node N -m cloud_server_tpu_torch.train
--distributed ...` (NCCL, one card a rank; gloo with `--device cpu`),
which reads torchrun's environment (`parallel.distributed.initialize`).
Each rank holds its shards of the parameters and optimizer state, rank
0 logs and writes the checkpoints. Dense and MoE models (experts over
ep) and `--lora-rank` adapters train on any mesh, as in the reference;
as there, the CLI never pipelines: a pp axis here holds replicas (the
pipelined loss is `parallel.pipeline.make_pipelined_loss`, passed to
`make_train_step`). A "dcn_mesh" section asks for a hybrid mesh over
several hosts (`parallel.distributed.make_hybrid_mesh`): the batch must
divide the global dp x fsdp.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cloud_server_tpu_torch.train",
        description="Train a dense or MoE decoder LM on one GPU, or over "
        "a mesh of GPUs (one process a rank).")
    p.add_argument("--config", help="JSON config file with optional "
                   "model/train/mesh/loop sections")
    p.add_argument("--data", action="append", default=None,
                   help="flat binary token file (uint16). Repeatable; "
                   "with several, pass 'path:weight' to train on a "
                   "deterministic weighted mixture (weight defaults to 1)")
    p.add_argument("--eval-data", help="eval token file (same format)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="use N synthetic random examples instead of --data")
    p.add_argument("--steps", type=int, help="override train.total_steps")
    p.add_argument("--batch-size", type=int, help="override train.batch_size")
    p.add_argument("--seq-len", type=int, help="override train.seq_len")
    p.add_argument("--learning-rate", type=float,
                   help="override train.learning_rate")
    p.add_argument("--checkpoint-dir", help="override loop.checkpoint_dir")
    p.add_argument("--logdir", help="override loop.logdir")
    p.add_argument("--eval-interval", type=int,
                   help="override loop.eval_interval (defaults to 500 when "
                   "--eval-data is given and the config leaves it 0)")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group of a multi-process run "
                   "from torchrun's environment (NCCL on cards, gloo with "
                   "--device cpu); each rank trains on its own card")
    p.add_argument("--no-nan-guard", action="store_true",
                   help="disable the NaN/inf loss guard")
    from cloud_server_tpu_torch.models.lora import add_lora_args
    add_lora_args(p)
    p.add_argument("--init-from", metavar="CKPT_DIR",
                   help="load pretrained base params from this training "
                   "checkpoint (requires --lora-rank)")
    p.add_argument("--watchdog", type=float, default=0.0, metavar="SECONDS",
                   help="abort (with stack dump) if a step makes no "
                   "progress for this long; 0 disables")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    return p


def configs_from_args(args) -> tuple:
    """(ModelConfig, TrainConfig, MeshConfig, LoopConfig, dcn MeshConfig
    or None) from file + flags. A "dcn_mesh" section requests a hybrid
    mesh over hosts: its axes say how the "mesh" section's layout is
    replicated across them."""
    from cloud_server_tpu_torch.config import (
        MeshConfig, ModelConfig, TrainConfig, from_json)
    from cloud_server_tpu_torch.training.loop import LoopConfig

    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    model_cfg = from_json(ModelConfig, raw.get("model", {}))
    train_cfg = from_json(TrainConfig, raw.get("train", {}))
    mesh_cfg = from_json(MeshConfig, raw.get("mesh", {}))
    loop_cfg = from_json(LoopConfig, raw.get("loop", {}))
    dcn_cfg = (from_json(MeshConfig, raw["dcn_mesh"])
               if "dcn_mesh" in raw else None)

    train_over = {k: v for k, v in {
        "total_steps": args.steps, "batch_size": args.batch_size,
        "seq_len": args.seq_len, "learning_rate": args.learning_rate,
    }.items() if v is not None}
    if train_over:
        train_cfg = dataclasses.replace(train_cfg, **train_over)
    loop_over = {k: v for k, v in {
        "checkpoint_dir": args.checkpoint_dir, "logdir": args.logdir,
        "eval_interval": args.eval_interval,
    }.items() if v is not None}
    # --eval-data with eval_interval 0 would silently never evaluate
    if args.eval_data and "eval_interval" not in loop_over \
            and loop_cfg.eval_interval == 0:
        loop_over["eval_interval"] = 500
        print("[train] --eval-data given without eval_interval; "
              "defaulting loop.eval_interval=500")
    if loop_over:
        loop_cfg = dataclasses.replace(loop_cfg, **loop_over)
    return model_cfg, train_cfg, mesh_cfg, loop_cfg, dcn_cfg


def hybrid_mesh(train_cfg, mesh_cfg, dcn_cfg, device):
    """(the global MeshConfig, the hybrid DeviceMesh) of a "dcn_mesh"
    section; SystemExit when the batch does not divide the global batch
    axes."""
    from cloud_server_tpu_torch.parallel.distributed import (
        global_mesh_config, make_hybrid_mesh)
    g = global_mesh_config(mesh_cfg, dcn_cfg)
    batch_shards = g.dp * g.fsdp
    if train_cfg.batch_size % batch_shards:
        raise SystemExit(
            f"batch_size {train_cfg.batch_size} not divisible by the "
            f"GLOBAL batch-sharding axes dp×fsdp = {g.dp}×{g.fsdp} = "
            f"{batch_shards} (mesh × dcn_mesh)")
    return g, make_hybrid_mesh(mesh_cfg, dcn_cfg, device.type)


def _join(args):
    """(device, mesh or None): with --distributed, the process group from
    torchrun's environment and this rank's card (LOCAL_RANK)."""
    import os

    import torch

    from cloud_server_tpu_torch import resolve_device
    device = resolve_device(args.device)
    if not args.distributed:
        return device
    from cloud_server_tpu_torch.parallel.distributed import initialize
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    initialize(backend="nccl" if device.type == "cuda" else "gloo")
    return device


def build_dataset(args, train_cfg, model_cfg):
    from cloud_server_tpu_torch.data.dataset import (
        MemmapTokenDataset, MixtureDataset, SyntheticLMDataset)
    if args.synthetic:
        return SyntheticLMDataset(args.synthetic, train_cfg.seq_len,
                                  model_cfg.vocab_size, seed=train_cfg.seed)
    if not args.data:
        raise SystemExit("one of --data or --synthetic is required")
    specs = []
    for entry in args.data:
        path, sep, w = entry.rpartition(":")
        if sep and path and not w:
            raise SystemExit(
                f"--data entry {entry!r} has an empty weight after ':' — "
                "use path:weight (e.g. data.bin:2.0) or just the path")
        try:
            weight, path = (float(w), path) if path else (1.0, entry)
        except ValueError:
            weight, path = 1.0, entry  # ':' was part of the path
        specs.append((path, weight))
    if len(specs) == 1:
        return MemmapTokenDataset(specs[0][0], train_cfg.seq_len)
    return MixtureDataset([MemmapTokenDataset(p, train_cfg.seq_len)
                           for p, _ in specs],
                          [w for _, w in specs], seed=train_cfg.seed)


def lora_module(args, model_cfg, train_cfg, loop_cfg, device):
    """The LoRA module of --lora-rank (over the config's family, its base
    restored from --init-from when given), with its sidecar written into
    the checkpoint directory; None without --lora-rank."""
    from cloud_server_tpu_torch.models import moe
    if args.init_from and not args.lora_rank:
        raise SystemExit("--init-from currently requires --lora-rank "
                         "(full-model warm start is not wired up yet)")
    if args.lora_rank <= 0:
        return None
    from cloud_server_tpu_torch.generate import load_params
    from cloud_server_tpu_torch.models.lora import (
        lora_config_from_args, make_lora_module, save_lora_config)
    lcfg = lora_config_from_args(args)
    base_params = None
    if args.init_from:
        base_params = load_params(model_cfg, args.init_from, None,
                                  train_cfg.seed, device)
    module = make_lora_module(lcfg, base_module=moe.module_for(model_cfg),
                              base_params=base_params)
    from cloud_server_tpu_torch.parallel.distributed import is_primary
    if loop_cfg.checkpoint_dir and is_primary():  # one writer on a mesh
        save_lora_config(loop_cfg.checkpoint_dir, lcfg)
    return module


def main(argv=None):
    """Run the CLI; returns the final TrainState."""
    args = build_parser().parse_args(argv)
    model_cfg, train_cfg, mesh_cfg, loop_cfg, dcn_cfg = configs_from_args(
        args)

    from cloud_server_tpu_torch.data.dataset import MemmapTokenDataset
    from cloud_server_tpu_torch.training.loop import train_loop
    from cloud_server_tpu_torch.utils.failure import (
        NaNGuard, PreemptionHandler, Watchdog)

    device = _join(args)
    mesh = None
    if dcn_cfg is not None:
        mesh_cfg, mesh = hybrid_mesh(train_cfg, mesh_cfg, dcn_cfg, device)
    dataset = build_dataset(args, train_cfg, model_cfg)
    eval_dataset = (MemmapTokenDataset(args.eval_data, train_cfg.seq_len)
                    if args.eval_data else None)
    loss_fn_module = lora_module(args, model_cfg, train_cfg, loop_cfg,
                                 device)
    hooks = []
    with contextlib.ExitStack() as stack:
        preempt = stack.enter_context(PreemptionHandler())
        hooks.append(preempt)  # SIGTERM -> save + clean stop
        if not args.no_nan_guard:
            hooks.append(NaNGuard())
        if args.watchdog > 0:
            hooks.append(stack.enter_context(Watchdog(args.watchdog)))
        try:
            state = train_loop(model_cfg, train_cfg, dataset,
                               mesh_cfg=mesh_cfg, loop_cfg=loop_cfg,
                               eval_dataset=eval_dataset,
                               loss_fn_module=loss_fn_module, hooks=hooks,
                               device=device, mesh=mesh)
            if args.distributed:
                # the ranks leave together, none while rank 0 still
                # writes the last checkpoint
                import torch.distributed as dist
                dist.barrier()
            return state
        finally:
            if args.distributed:
                import torch.distributed as dist
                if dist.is_initialized():
                    dist.destroy_process_group()


if __name__ == "__main__":
    main()
