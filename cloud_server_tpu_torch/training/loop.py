"""The training loop: data -> train step -> metrics, on one device.

Orchestrates the port's subsystems as the reference's loop does:
  * the train step (`train_step.py`),
  * the resumable data pipeline (`data/loader.py`),
  * throughput/MFU accounting + JSONL logging (`utils/`),
  * failure hooks — callables invoked every step with (step, state,
    metrics); a hook may raise to abort or return a replacement state
    (`utils/failure.py`).

Blocking discipline: the loop reads device results on the host only at
log boundaries, so up to `log_interval` steps queue on the card while the
host prepares the next batches. Checkpointing and periodic evaluation are
not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from cloud_server_tpu_torch.data.loader import DataLoader
from cloud_server_tpu_torch.training.train_step import (
    check_single_device, init_train_state, make_train_step)
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
    data_prefetch: int = 2
    shuffle: bool = True


# A hook sees (step, state, metrics) after each train step. It may return
# None (observe only) or a replacement TrainState.
Hook = Callable[[int, object, dict], object | None]


def train_loop(model_cfg: ModelConfig, train_cfg: TrainConfig,
               dataset, *, mesh_cfg: MeshConfig | None = None,
               loop_cfg: LoopConfig | None = None, eval_dataset=None,
               loss_fn=None, hooks: Sequence[Hook] = (),
               max_steps: int | None = None, device=None):
    """Run training to `train_cfg.total_steps` on `device` (CUDA unless
    named); returns the final TrainState. `max_steps` stops this run
    early without touching `total_steps`, which the schedule reads."""
    loop_cfg = loop_cfg or LoopConfig()
    check_single_device(mesh_cfg)
    if loop_cfg.checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpointing (checkpoint_dir) is not ported yet")
    if eval_dataset is not None:
        raise NotImplementedError(
            "periodic evaluation (eval_dataset) is not ported yet")
    device = resolve_device(device)

    step_fn = make_train_step(model_cfg, train_cfg, mesh_cfg,
                              loss_fn=loss_fn)
    state = init_train_state(model_cfg, train_cfg, train_cfg.seed, device)
    loader = DataLoader(dataset, train_cfg.batch_size, device,
                        seed=train_cfg.seed, shuffle=loop_cfg.shuffle,
                        prefetch=loop_cfg.data_prefetch)

    tokens_per_step = train_cfg.batch_size * train_cfg.seq_len
    timer = StepTimer(
        flops_per_token=transformer_flops_per_token(
            model_cfg, train_cfg.seq_len),
        device=device,
        window=max(1, 100 // max(1, loop_cfg.log_interval)))
    agg = MetricAggregator()
    logger = MetricLogger(loop_cfg.logdir)

    stop_at = train_cfg.total_steps if max_steps is None else min(
        train_cfg.total_steps, max_steps)
    data_it = iter(loader)
    step = last_logged = state.step
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
    finally:
        logger.close()
    return state
