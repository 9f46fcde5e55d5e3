"""The training loop: data -> train step -> metrics/ckpt/eval, on one
device or as one rank of a mesh.

Orchestrates the port's subsystems as the reference's loop does:
  * the train step (`train_step.py`),
  * the resumable data pipeline (`data/loader.py`), fast-forwarded to the
    restored step (the sampler is deterministic in (seed, step), so no
    separate data-state file is needed),
  * checkpointing with cadence and retention (`checkpoint.py`): resume
    at start, saves at `checkpoint_interval`, a forced save at the end
    and on KeyboardInterrupt (preemption), never after another error,
  * throughput/MFU accounting + JSONL logging (`utils/`),
  * periodic token-weighted evaluation (`eval.py`), of the EMA params too
    when the optimizer keeps them,
  * failure hooks — callables invoked every step with (step, state,
    metrics); a hook may raise to abort or return a replacement state
    (`utils/failure.py`); hooks with `beat()` are beaten around eval and
    checkpoint writes.

On a mesh (`mesh=`, or one built from a `mesh_cfg` of more than one
device over the initialized process group) every rank runs the loop on
its shards and its block of each batch; rank 0 alone logs, prints and
writes the checkpoints (of the gathered leaves: `checkpoint.py`).

Blocking discipline: the loop reads device results on the host only at
log, eval and checkpoint boundaries, so up to `log_interval` steps queue
on the card while the host prepares the next batches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from cloud_server_tpu_torch.data.loader import DataLoader
from cloud_server_tpu_torch.parallel.distributed import is_primary
from cloud_server_tpu_torch.parallel.mesh import make_mesh
from cloud_server_tpu_torch.training.checkpoint import (Checkpointer,
                                                        restore_or_init)
from cloud_server_tpu_torch.training.eval import evaluate, make_eval_step
from cloud_server_tpu_torch.training.optim import ema_params
from cloud_server_tpu_torch.training.train_step import (
    check_mesh, init_train_state, make_train_step)
from cloud_server_tpu_torch.utils.logging import MetricLogger
from cloud_server_tpu_torch.utils.metrics import (
    MetricAggregator, StepTimer, transformer_flops_per_token)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Knobs of the loop itself (cadences, paths) — everything that is not
    model/mesh/optimizer math."""

    log_interval: int = 10  # 0 => log only at the end of the run
    logdir: str | None = None
    checkpoint_dir: str | None = None
    checkpoint_interval: int = 500  # 0 => final save only
    max_checkpoints: int = 3
    async_checkpoint: bool = True
    eval_interval: int = 0  # 0 => no periodic eval
    eval_batches: int = 16
    data_prefetch: int = 2
    shuffle: bool = True


# A hook sees (step, state, metrics) after each train step. It may return
# None (observe only) or a replacement TrainState.
Hook = Callable[[int, object, dict], object | None]


def _beat_hooks(hooks: Sequence[Hook]) -> None:
    """Hooks exposing `beat()` (a Watchdog) are beaten around long
    hook-free phases — eval sweeps, checkpoint writes — so those phases
    only need to finish within one watchdog timeout."""
    for h in hooks:
        beat = getattr(h, "beat", None)
        if callable(beat):
            beat()


def train_loop(model_cfg: ModelConfig, train_cfg: TrainConfig,
               dataset, *, mesh_cfg: MeshConfig | None = None,
               loop_cfg: LoopConfig | None = None, eval_dataset=None,
               loss_fn_module=None, loss_fn=None,
               hooks: Sequence[Hook] = (), max_steps: int | None = None,
               device=None, mesh=None, rules=None):
    """Run training to `train_cfg.total_steps` on `device` (CUDA unless
    named); returns the final TrainState.

    Resumes from `loop_cfg.checkpoint_dir` when a checkpoint exists
    there. `max_steps` stops this run early (e.g. to simulate
    preemption) without touching `total_steps`, which the schedule
    reads. `loss_fn_module` is the model family (`models.transformer`,
    `models.moe`, a LoRA module; the family of model_cfg by default).
    `mesh`: the DeviceMesh this rank trains on; without it a `mesh_cfg`
    of more than one device builds one over the process group (on
    `device`'s type). `rules`: the sharding rules of the state
    (DEFAULT_RULES by default), as the reference's loop takes them."""
    loop_cfg = loop_cfg or LoopConfig()
    check_mesh(mesh_cfg, model_cfg, loss_fn_module)
    device = resolve_device(device)
    if mesh is None and mesh_cfg is not None and mesh_cfg.num_devices > 1:
        mesh = make_mesh(mesh_cfg, device.type)

    step_fn = make_train_step(model_cfg, train_cfg, mesh_cfg,
                              loss_fn=loss_fn, loss_fn_module=loss_fn_module,
                              mesh=mesh, rules=rules)
    ckpt = None
    resumed = False
    if loop_cfg.checkpoint_dir is not None:
        ckpt = Checkpointer(
            loop_cfg.checkpoint_dir, max_to_keep=loop_cfg.max_checkpoints,
            save_interval_steps=max(1, loop_cfg.checkpoint_interval),
            async_save=loop_cfg.async_checkpoint, mesh=mesh,
            model_cfg=model_cfg, loss_fn_module=loss_fn_module,
            rules=rules)
        state, resumed = restore_or_init(ckpt, model_cfg, train_cfg,
                                         train_cfg.seed, device,
                                         loss_fn_module)
    else:
        state = init_train_state(model_cfg, train_cfg, train_cfg.seed, device,
                                 loss_fn_module, mesh=mesh, rules=rules)
    start_step = int(state.step)

    loader = DataLoader.for_mesh(dataset, train_cfg.batch_size, device, mesh,
                                 seed=train_cfg.seed,
                                 shuffle=loop_cfg.shuffle,
                                 prefetch=loop_cfg.data_prefetch)
    # one train step consumes one global batch, so the sampler position
    # is a function of the restored step
    bpe = loader.sampler.batches_per_epoch
    loader.load_state_dict({"epoch": start_step // bpe,
                            "batch_in_epoch": start_step % bpe})

    eval_step = None
    if eval_dataset is not None and loop_cfg.eval_interval > 0:
        eval_step = make_eval_step(model_cfg, loss_fn=loss_fn,
                                   loss_fn_module=loss_fn_module, mesh=mesh,
                                   rules=rules)
        # prefetch=0: evaluate() stops mid-stream after eval_batches, and
        # an abandoned prefetch thread would block on its full queue
        eval_loader = DataLoader.for_mesh(eval_dataset, train_cfg.batch_size,
                                          device, mesh, seed=train_cfg.seed,
                                          shuffle=False, prefetch=0)

    tokens_per_step = train_cfg.batch_size * train_cfg.seq_len
    timer = StepTimer(
        flops_per_token=transformer_flops_per_token(
            model_cfg, train_cfg.seq_len),
        device=device,
        window=max(1, 100 // max(1, loop_cfg.log_interval)))
    agg = MetricAggregator()
    logger = MetricLogger(loop_cfg.logdir,
                          process_index=0 if is_primary() else 1)
    if resumed and is_primary():
        print(f"[loop] resumed from step {start_step} "
              f"({loop_cfg.checkpoint_dir})")

    stop_at = train_cfg.total_steps if max_steps is None else min(
        train_cfg.total_steps, max_steps)
    data_it = iter(loader)
    step = last_logged = start_step
    try:
        while step < stop_at:
            batch = next(data_it)
            state, metrics = step_fn(state, batch)
            step += 1
            agg.update(metrics)

            for hook in hooks:
                replacement = hook(step, state, metrics)
                if replacement is not None:
                    state = replacement

            if ((loop_cfg.log_interval > 0
                 and step % loop_cfg.log_interval == 0) or step == stop_at):
                flushed = agg.flush()  # reads the device: the sync point
                flushed.update(timer.tick(
                    tokens_per_step * (step - last_logged)))
                last_logged = step
                logger.log(step, flushed)

            if eval_step is not None and step % loop_cfg.eval_interval == 0:
                _beat_hooks(hooks)
                eval_metrics = {}
                trees = [("", state.params)]
                averaged = ema_params(state.opt_state)
                if averaged is not None:
                    trees.append(("ema_", averaged))
                for prefix, tree in trees:
                    eval_loader.load_state_dict({"epoch": 0,
                                                 "batch_in_epoch": 0})
                    eval_metrics.update({
                        f"{prefix}{k}": v for k, v in evaluate(
                            tree, iter(eval_loader), eval_step,
                            max_batches=loop_cfg.eval_batches).items()})
                logger.log(step, eval_metrics)
                _beat_hooks(hooks)

            if (ckpt is not None and loop_cfg.checkpoint_interval > 0
                    and step % loop_cfg.checkpoint_interval == 0):
                ckpt.save(state)
                _beat_hooks(hooks)
    except KeyboardInterrupt:
        # preemption: the state at this step boundary is valid — persist
        # it so the next launch resumes from here
        if ckpt is not None:
            _beat_hooks(hooks)
            ckpt.save(state, force=True)
        raise
    else:
        if ckpt is not None:
            _beat_hooks(hooks)  # the final save can outlast a watchdog window
            ckpt.save(state, force=True)
    finally:
        # any other exception (a NaN-guard abort) must not save: it would
        # checkpoint corrupt params, and retention could evict the last
        # good checkpoint
        data_it.close()  # stops the loader's prefetch thread
        if ckpt is not None:
            ckpt.close()
        logger.close()
    return state
