"""PyTorch/CUDA port of cloud_server_tpu for NVIDIA Hopper (H100).

A second implementation beside the JAX package, held against it by the
tests under tests/test_torch_*.py. It imports torch and numpy only —
never jax and nothing of the reference package. Entry points run on the
card (`device="cuda"`) unless the caller asks for the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    one. Asking for CUDA without a card raises; nothing falls back to the
    CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev
