"""Training CLI: `python -m cloud_server_tpu_torch.train`.

Config comes from a JSON file with optional sections {"model", "train",
"mesh", "loop"} (the reference's format), with common fields
overridable from the command line. Data is a flat binary token file
(`--data`, the `MemmapTokenDataset` format; several as a weighted
mixture) or `--synthetic N` random examples. Runs on the GPU unless
`--device cpu` is given.

Not ported yet, and refused with NotImplementedError: checkpointing
(`--checkpoint-dir`, loop.checkpoint_dir), evaluation (`--eval-data`),
multi-process runs (`--distributed`), LoRA (`--lora-rank`,
`--init-from`), a mesh with any axis > 1 and a "dcn_mesh" section.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cloud_server_tpu_torch.train",
        description="Train a dense decoder LM on one GPU.")
    p.add_argument("--config", help="JSON config file with optional "
                   "model/train/mesh/loop sections")
    p.add_argument("--data", action="append", default=None,
                   help="flat binary token file (uint16). Repeatable; "
                   "with several, pass 'path:weight' to train on a "
                   "deterministic weighted mixture (weight defaults to 1)")
    p.add_argument("--eval-data", help="eval token file (not ported yet)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="use N synthetic random examples instead of --data")
    p.add_argument("--steps", type=int, help="override train.total_steps")
    p.add_argument("--batch-size", type=int, help="override train.batch_size")
    p.add_argument("--seq-len", type=int, help="override train.seq_len")
    p.add_argument("--learning-rate", type=float,
                   help="override train.learning_rate")
    p.add_argument("--checkpoint-dir", help="not ported yet")
    p.add_argument("--logdir", help="override loop.logdir")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process training (not ported yet)")
    p.add_argument("--no-nan-guard", action="store_true",
                   help="disable the NaN/inf loss guard")
    p.add_argument("--lora-rank", type=int, default=0,
                   help="LoRA fine-tuning (not ported yet)")
    p.add_argument("--init-from", metavar="CKPT_DIR",
                   help="load base params from a checkpoint (not ported "
                   "yet)")
    p.add_argument("--watchdog", type=float, default=0.0, metavar="SECONDS",
                   help="abort (with stack dump) if a step makes no "
                   "progress for this long; 0 disables")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    return p


def configs_from_args(args) -> tuple:
    """(ModelConfig, TrainConfig, MeshConfig, LoopConfig) from file +
    flags."""
    from cloud_server_tpu_torch.config import (
        MeshConfig, ModelConfig, TrainConfig, from_json)
    from cloud_server_tpu_torch.training.loop import LoopConfig

    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    if "dcn_mesh" in raw:
        raise NotImplementedError("a dcn_mesh (multi-slice) section is not "
                                  "ported yet")
    model_cfg = from_json(ModelConfig, raw.get("model", {}))
    train_cfg = from_json(TrainConfig, raw.get("train", {}))
    mesh_cfg = from_json(MeshConfig, raw.get("mesh", {}))
    loop_cfg = from_json(LoopConfig, raw.get("loop", {}))

    train_over = {k: v for k, v in {
        "total_steps": args.steps, "batch_size": args.batch_size,
        "seq_len": args.seq_len, "learning_rate": args.learning_rate,
    }.items() if v is not None}
    if train_over:
        train_cfg = dataclasses.replace(train_cfg, **train_over)
    if args.logdir is not None:
        loop_cfg = dataclasses.replace(loop_cfg, logdir=args.logdir)
    return model_cfg, train_cfg, mesh_cfg, loop_cfg


def _refuse_unported(args, mesh_cfg, loop_cfg) -> None:
    for flag, value in (("--checkpoint-dir", args.checkpoint_dir),
                        ("--eval-data", args.eval_data),
                        ("--distributed", args.distributed),
                        ("--lora-rank", args.lora_rank),
                        ("--init-from", args.init_from)):
        if value:
            raise NotImplementedError(f"{flag} is not ported yet")
    if mesh_cfg.num_devices > 1:
        raise NotImplementedError(
            f"mesh {mesh_cfg.axis_sizes()}: training on more than one "
            "device is not ported yet")
    if loop_cfg.checkpoint_dir is not None:
        raise NotImplementedError("loop.checkpoint_dir is not ported yet")


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


def main(argv=None):
    """Run the CLI; returns the final TrainState."""
    args = build_parser().parse_args(argv)
    model_cfg, train_cfg, mesh_cfg, loop_cfg = configs_from_args(args)
    _refuse_unported(args, mesh_cfg, loop_cfg)

    from cloud_server_tpu_torch import resolve_device
    from cloud_server_tpu_torch.training.loop import train_loop
    from cloud_server_tpu_torch.utils.failure import (
        NaNGuard, PreemptionHandler, Watchdog)

    device = resolve_device(args.device)
    dataset = build_dataset(args, train_cfg, model_cfg)
    hooks = []
    with contextlib.ExitStack() as stack:
        preempt = stack.enter_context(PreemptionHandler())
        hooks.append(preempt)  # SIGTERM -> clean stop at a step boundary
        if not args.no_nan_guard:
            hooks.append(NaNGuard())
        if args.watchdog > 0:
            hooks.append(stack.enter_context(Watchdog(args.watchdog)))
        return train_loop(model_cfg, train_cfg, dataset, mesh_cfg=mesh_cfg,
                          loop_cfg=loop_cfg, hooks=hooks, device=device)


if __name__ == "__main__":
    main()
