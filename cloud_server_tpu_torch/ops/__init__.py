"""Plain PyTorch ops and the kernel wrappers of the port."""

from cloud_server_tpu_torch.ops.activations import swiglu
from cloud_server_tpu_torch.ops.attention import causal_attention
from cloud_server_tpu_torch.ops.matmul import matmul_f32
from cloud_server_tpu_torch.ops.norms import rms_norm
from cloud_server_tpu_torch.ops.rope import apply_rope, rope_table

__all__ = ["apply_rope", "causal_attention", "matmul_f32", "rms_norm",
           "rope_table", "swiglu"]
