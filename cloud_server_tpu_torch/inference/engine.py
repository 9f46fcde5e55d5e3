"""The piece of the reference's contiguous engine the paged path uses:
the MLP residual block selected by the config. The contiguous KV cache
and its generate loop are not ported yet."""

from __future__ import annotations

from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import transformer


def _mlp_apply(x, lp, cfg: ModelConfig):
    """Dense MLP residual block. Mixture-of-experts models are not
    ported yet and raise."""
    if cfg.num_experts >= 2:
        raise NotImplementedError("MoE models are not ported yet")
    return transformer.mlp_block(x, lp, cfg)
