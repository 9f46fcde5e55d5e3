"""The port's counterpart of the repository root's `__graft_entry__.entry`:
a forward step on the flagship dense LM at its fixed config, one card.

`entry(device=None)` returns `(fn, (params, tokens))`: `fn` is the
port's `models.transformer.forward`, bound to the config (V 32000,
D 1024, 8 layers, 8 heads, 8 KV heads, Dh 128, F 4096, max_seq_len
1024; the rest ModelConfig's defaults, as the reference's), `params`
drawn from seed 0 and `tokens` zeros (2, 256) int64. It runs on the card
unless the caller asks for the CPU (`device="cpu"`).

    fn, args = entry()
    with torch.no_grad():
        logits = fn(*args)   # (2, 256, 32000) float32
"""

from __future__ import annotations


def entry(device=None):
    import torch

    from cloud_server_tpu_torch import resolve_device
    from cloud_server_tpu_torch.config import ModelConfig
    from cloud_server_tpu_torch.models import transformer

    device = resolve_device(device)
    cfg = ModelConfig(
        vocab_size=32000, embed_dim=1024, num_layers=8, num_heads=8,
        num_kv_heads=8, head_dim=128, mlp_dim=4096, max_seq_len=1024)
    params = transformer.init_params(cfg, 0, device=device)
    tokens = torch.zeros((2, 256), dtype=torch.int64, device=device)

    def fn(params, tokens):
        return transformer.forward(params, tokens, cfg)

    fn.cfg = cfg
    return fn, (params, tokens)
