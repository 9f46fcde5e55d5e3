"""Checkpoint conversion CLI: `python -m cloud_server_tpu_torch.convert`.

Export a training checkpoint of the port to a HuggingFace LLaMA-family
directory (`config.json` + a float32 `model.safetensors`, loadable with
`transformers.AutoModelForCausalLM.from_pretrained`), the inverse of
`generate --hf-checkpoint`: bring weights in, train or fine-tune here,
take them back out. The directory is written by the port itself
(`models.hf_convert.save_hf_checkpoint`), without `transformers` or
`safetensors`. The parameters are restored on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cloud_server_tpu_torch.convert",
        description="Export a training checkpoint to a HuggingFace "
        "LLaMA-family directory.")
    p.add_argument("--config", required=True,
                   help="JSON config with the model section used at "
                   "training time")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--step", type=int, help="checkpoint step (default latest)")
    p.add_argument("--out", required=True, metavar="DIR",
                   help="output HF checkpoint directory")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA-averaged weights (needs a run "
                   "trained with ema_decay > 0)")
    p.add_argument("--device", default=None,
                   help="torch device the parameters are restored on "
                   "(default cuda; 'cpu' to run on the CPU)")
    return p


def main(argv=None) -> dict:
    """Export; returns {"out", "bytes", "write_s"} (the directory's bytes
    and the seconds its write took, the restore excluded)."""
    args = build_parser().parse_args(argv)

    from cloud_server_tpu_torch import resolve_device
    from cloud_server_tpu_torch.config import ModelConfig, from_json
    from cloud_server_tpu_torch.models.hf_convert import save_hf_checkpoint

    device = resolve_device(args.device)
    with open(args.config) as f:
        raw = json.load(f)
    model_cfg = from_json(ModelConfig, raw.get("model", {}))
    if model_cfg.num_experts >= 2:
        raise SystemExit(
            "HF export supports the dense LLaMA family only (the MoE "
            "layout has no LlamaForCausalLM equivalent)")

    if args.ema:
        from cloud_server_tpu_torch.training.checkpoint import (
            restore_ema_params)
        try:
            params = restore_ema_params(args.checkpoint_dir, model_cfg,
                                        step=args.step, device=device)
        except FileNotFoundError as e:
            raise SystemExit(str(e))
    else:
        from cloud_server_tpu_torch.training.checkpoint import (
            restore_params)
        params = restore_params(args.checkpoint_dir, model_cfg,
                                step=args.step, device=device)

    t0 = time.perf_counter()
    nbytes = save_hf_checkpoint(params, model_cfg, args.out)
    write_s = time.perf_counter() - t0
    print(f"[convert] wrote HF checkpoint to {args.out} ({nbytes} bytes, "
          f"{write_s:.3f} s)", file=sys.stderr)
    return {"out": args.out, "bytes": nbytes, "write_s": write_s}


if __name__ == "__main__":
    main()
