"""HuggingFace LLaMA-family checkpoint interop on the port.

The reference's `models/hf_convert.py` on PyTorch: `LlamaForCausalLM`
state dicts convert losslessly to and from the port's parameter tree
(the same names and layouts as the reference's). The RoPE convention
matches (the half-split "rotate_half" layout and the same theta
schedule), so conversion is reshaping and transposition only.

Layout mapping (HF `nn.Linear.weight` is (out, in)):

  model.embed_tokens.weight (V, D)      -> embed.tokens (V, D)
  layers.i.self_attn.q_proj (H*Dh, D)   -> wq[i] (D, H, Dh)    (T + reshape)
  layers.i.self_attn.k_proj (KH*Dh, D)  -> wk[i] (D, KH, Dh)
  layers.i.self_attn.v_proj (KH*Dh, D)  -> wv[i] (D, KH, Dh)
  layers.i.self_attn.o_proj (D, H*Dh)   -> wo[i] (H, Dh, D)
  layers.i.mlp.gate_proj (F, D)         -> w_gate[i] (D, F)
  layers.i.mlp.up_proj (F, D)           -> w_up[i] (D, F)
  layers.i.mlp.down_proj (D, F)         -> w_down[i] (F, D)
  layers.i.input_layernorm (D,)         -> attn_norm[i]
  layers.i.post_attention_layernorm (D,)-> mlp_norm[i]
  model.norm.weight (D,)                -> final_norm.scale
  lm_head.weight (V, D)                 -> lm_head.kernel (D, V)
                                           (absent when tie_word_embeddings)

The port reads and writes the HF directory itself, with neither
`transformers` nor `safetensors`: `config.json`, then `model.safetensors`
or the shards `model.safetensors.index.json` names (read with
`models.safetensors_io`), else `pytorch_model.bin` through
`torch.load(weights_only=True)`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import safetensors_io
from cloud_server_tpu_torch.models.transformer import torch_dtype

# Overriding these changes the parameter-tree shapes / semantics and can
# only corrupt a conversion, so config_from_hf rejects them rather than
# forwarding them into a reshape error deep inside params_from_hf.
_STRUCTURAL_FIELDS = frozenset({
    "vocab_size", "embed_dim", "num_layers", "num_heads", "num_kv_heads",
    "head_dim", "mlp_dim", "tie_embeddings", "num_experts",
    "rope_theta", "rope_scaling", "rope_scaling_factor",
    "rope_low_freq_factor", "rope_high_freq_factor", "rope_original_max_len",
})

# transformers.LlamaConfig's defaults: what a config.json key that is
# absent means (num_key_value_heads and head_dim default from the heads)
_LLAMA_DEFAULTS = {
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": None, "head_dim": None, "hidden_act": "silu",
    "max_position_embeddings": 2048, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "rope_theta": 10000.0,
    "rope_scaling": None, "attention_bias": False, "mlp_bias": False,
}


def _hf_get(hf_config: Any, key: str):
    """A field of a transformers config object or of a config.json dict,
    LlamaConfig's default when it is absent."""
    if isinstance(hf_config, Mapping):
        value = hf_config.get(key)
    else:
        value = getattr(hf_config, key, None)
    return _LLAMA_DEFAULTS.get(key) if value is None else value


def _rope_fields_from_hf(hf_config: Any) -> dict:
    """Map transformers' rope_scaling dict onto ModelConfig rope fields.

    Supported: absent/default (no scaling), "linear", "llama3". Anything
    else (yarn, dynamic, longrope...) raises — silently dropping the
    schedule would serve wrong logits at every position."""
    rs = _hf_get(hf_config, "rope_scaling")
    if not rs:
        return {}
    kind = rs.get("rope_type", rs.get("type", "default"))
    if kind in (None, "default"):
        return {}
    if kind == "linear":
        return dict(rope_scaling="linear",
                    rope_scaling_factor=float(rs["factor"]))
    if kind == "llama3":
        return dict(
            rope_scaling="llama3",
            rope_scaling_factor=float(rs["factor"]),
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_original_max_len=int(
                rs.get("original_max_position_embeddings", 8192)))
    raise ValueError(
        f"unsupported rope_scaling type {kind!r} in HF config — supported: "
        "default/linear/llama3")


def config_from_hf(hf_config: Any, **overrides) -> ModelConfig:
    """A ModelConfig from a transformers LlamaConfig-like object or the
    dict of a `config.json` (a missing key takes LlamaConfig's default).

    `overrides` may adjust behavioral fields (dtype, attention_impl,
    remat, max_seq_len, ...); structural fields that must match the
    checkpoint tensors are rejected when they contradict the HF config.
    Unsupported architecture variants (non-SiLU activation, attention/MLP
    biases, exotic rope scaling) raise instead of converting silently
    wrong."""
    act = _hf_get(hf_config, "hidden_act")
    if act not in ("silu", "swish"):
        raise ValueError(f"unsupported hidden_act {act!r} (SwiGLU/SiLU only)")
    for bias_field in ("attention_bias", "mlp_bias"):
        if _hf_get(hf_config, bias_field):
            raise ValueError(
                f"unsupported {bias_field}=True — this framework's "
                "LLaMA-family layers are bias-free")
    heads = _hf_get(hf_config, "num_attention_heads")
    fields = dict(
        vocab_size=_hf_get(hf_config, "vocab_size"),
        embed_dim=_hf_get(hf_config, "hidden_size"),
        num_layers=_hf_get(hf_config, "num_hidden_layers"),
        num_heads=heads,
        num_kv_heads=_hf_get(hf_config, "num_key_value_heads") or heads,
        head_dim=_hf_get(hf_config, "head_dim")
        or _hf_get(hf_config, "hidden_size") // heads,
        mlp_dim=_hf_get(hf_config, "intermediate_size"),
        max_seq_len=_hf_get(hf_config, "max_position_embeddings"),
        rope_theta=float(_hf_get(hf_config, "rope_theta")),
        norm_eps=float(_hf_get(hf_config, "rms_norm_eps")),
        tie_embeddings=bool(_hf_get(hf_config, "tie_word_embeddings")),
        **_rope_fields_from_hf(hf_config),
    )
    # Structural fields the HF config doesn't mention still have a correct
    # value for this checkpoint: the ModelConfig default (dense model, no
    # rope scaling). Seed those so every structural override is compared
    # against SOMETHING.
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    for key, val in overrides.items():
        if key in _STRUCTURAL_FIELDS and val != fields.get(key, defaults[key]):
            raise ValueError(
                f"config override {key}={val!r} contradicts the checkpoint "
                f"({fields.get(key, defaults[key])!r}) — structural fields "
                "come from the HF config; drop the override")
    fields.update(overrides)
    return ModelConfig(**fields)


def _f32(t) -> torch.Tensor:
    """A state-dict entry (torch tensor or numpy array) as a float32
    CPU tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(t, np.float32))


# State-dict keys that are buffers/bookkeeping, not weights — safe to skip.
_IGNORABLE_KEY_PARTS = ("rotary_emb", "position_ids", "masked_bias",
                        "attn.bias")


def params_from_hf(state_dict: Mapping[str, Any], cfg: ModelConfig,
                   dtype: str | None = None, device=None) -> dict:
    """Convert an HF LlamaForCausalLM state dict to the port's parameter
    tree: leaves in `dtype` (default cfg.param_dtype) on `device` (the
    card unless named).

    Conversion runs one tensor family at a time through float32 — each
    per-layer stack is built, transposed, cast and moved to `device`,
    and its float32 intermediate freed before the next family starts —
    so peak host memory is the source checkpoint plus ONE float32 layer
    stack.

    Every state-dict key must either be consumed or match a known
    ignorable buffer pattern; leftovers (e.g. attention biases from a
    checkpoint with attention_bias=True) raise instead of being silently
    dropped."""
    device = resolve_device(device)
    L, D, H, KH, Dh = (cfg.num_layers, cfg.embed_dim, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    out_dtype = torch_dtype(dtype or cfg.param_dtype)
    consumed: set[str] = set()

    def get(key: str) -> torch.Tensor:
        consumed.add(key)
        return _f32(state_dict[key])

    def leaf(t: torch.Tensor) -> torch.Tensor:
        return t.contiguous().to(device=device, dtype=out_dtype)

    def stack(fmt: str, transform=None) -> torch.Tensor:
        arr = torch.stack([get(fmt.format(i)) for i in range(L)])
        if transform is not None:
            arr = transform(arr)
        return leaf(arr)

    layers = {
        "attn_norm": stack("model.layers.{}.input_layernorm.weight"),
        "mlp_norm": stack("model.layers.{}.post_attention_layernorm.weight"),
        # HF projections are (out, in); transpose then split the head dims.
        "wq": stack("model.layers.{}.self_attn.q_proj.weight",
                    lambda a: a.transpose(1, 2).reshape(L, D, H, Dh)),
        "wk": stack("model.layers.{}.self_attn.k_proj.weight",
                    lambda a: a.transpose(1, 2).reshape(L, D, KH, Dh)),
        "wv": stack("model.layers.{}.self_attn.v_proj.weight",
                    lambda a: a.transpose(1, 2).reshape(L, D, KH, Dh)),
        "wo": stack("model.layers.{}.self_attn.o_proj.weight",
                    lambda a: a.transpose(1, 2).reshape(L, H, Dh, D)),
        "w_gate": stack("model.layers.{}.mlp.gate_proj.weight",
                        lambda a: a.transpose(1, 2)),
        "w_up": stack("model.layers.{}.mlp.up_proj.weight",
                      lambda a: a.transpose(1, 2)),
        "w_down": stack("model.layers.{}.mlp.down_proj.weight",
                        lambda a: a.transpose(1, 2)),
    }
    params = {
        "embed": {"tokens": leaf(get("model.embed_tokens.weight"))},
        "layers": layers,
        "final_norm": {"scale": leaf(get("model.norm.weight"))},
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" not in state_dict:
            raise ValueError(
                "state dict has no lm_head.weight but cfg.tie_embeddings "
                "is False — pass a config with tie_embeddings=True")
        params["lm_head"] = {"kernel": leaf(get("lm_head.weight").T)}
    else:
        consumed.add("lm_head.weight")  # alias of the embedding when tied

    leftover = sorted(
        k for k in state_dict
        if k not in consumed
        and not any(part in k for part in _IGNORABLE_KEY_PARTS))
    if leftover:
        preview = ", ".join(leftover[:6])
        raise ValueError(
            f"{len(leftover)} unsupported weight(s) in checkpoint would be "
            f"silently dropped: {preview}"
            + (" ..." if len(leftover) > 6 else "")
            + " — this architecture variant (biases?) is not supported")
    return params


def params_to_hf(params: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """Inverse of `params_from_hf`: the port's tree -> an HF state dict
    of contiguous float32 CPU tensors (what `save_pretrained` writes)."""
    L, D, H, KH, Dh = (cfg.num_layers, cfg.embed_dim, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)

    def f32(t) -> torch.Tensor:
        return t.detach().to("cpu", torch.float32)

    sd: dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": f32(params["embed"]["tokens"])
        .contiguous(),
        "model.norm.weight": f32(params["final_norm"]["scale"]).contiguous(),
    }
    families = {  # one float32 family on the host at a time
        "input_layernorm": ("attn_norm", None),
        "post_attention_layernorm": ("mlp_norm", None),
        "self_attn.q_proj": ("wq", (D, H * Dh)),
        "self_attn.k_proj": ("wk", (D, KH * Dh)),
        "self_attn.v_proj": ("wv", (D, KH * Dh)),
        "self_attn.o_proj": ("wo", (H * Dh, D)),
        "mlp.gate_proj": ("w_gate", None),
        "mlp.up_proj": ("w_up", None),
        "mlp.down_proj": ("w_down", None),
    }
    for hf_name, (name, shape) in families.items():
        stack = f32(params["layers"][name])
        for i in range(L):
            t = stack[i]
            if t.dim() > 1:
                t = t.reshape(shape) if shape is not None else t
                t = t.T
            sd[f"model.layers.{i}.{hf_name}.weight"] = t.contiguous()
        del stack
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = f32(params["lm_head"]["kernel"]).T.contiguous()
    return sd


def hf_config_dict(cfg: ModelConfig) -> dict:
    """The `config.json` of a LlamaForCausalLM with `cfg`'s shapes: the
    fields the reference's export hands to LlamaConfig (no biases, SiLU,
    tied embeddings, rope scaling) plus what a transformers loader needs
    to pick the class."""
    rope = None
    if cfg.rope_scaling == "linear":
        rope = {"rope_type": "linear", "factor": cfg.rope_scaling_factor}
    elif cfg.rope_scaling == "llama3":
        rope = {"rope_type": "llama3", "factor": cfg.rope_scaling_factor,
                "low_freq_factor": cfg.rope_low_freq_factor,
                "high_freq_factor": cfg.rope_high_freq_factor,
                "original_max_position_embeddings":
                    cfg.rope_original_max_len}
    return {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.embed_dim,
        "intermediate_size": cfg.mlp_dim,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "rope_scaling": rope, "tie_word_embeddings": cfg.tie_embeddings,
        "attention_bias": False, "mlp_bias": False, "hidden_act": "silu",
        "torch_dtype": "float32",
    }


def save_hf_checkpoint(params: Mapping[str, Any], cfg: ModelConfig,
                       path: str | os.PathLike) -> int:
    """Write `params` as an HF LLaMA-family directory: `config.json` and
    one float32 `model.safetensors` (no `lm_head.weight` with tied
    embeddings). Returns the directory's bytes."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    nbytes = safetensors_io.save_file(
        params_to_hf(params, cfg), os.path.join(path, "model.safetensors"),
        metadata={"format": "pt"})
    return nbytes + os.path.getsize(os.path.join(path, "config.json"))


def read_hf_state_dict(path: str | os.PathLike) -> dict:
    """The weights of a local HF checkpoint directory as {name: CPU
    tensor}: `model.safetensors` or the shards its index names, else
    `pytorch_model.bin`."""
    path = os.fspath(path)
    single = os.path.join(path, "model.safetensors")
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(single):
        return safetensors_io.load_file(single)
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out: dict = {}
        for shard in shards:
            out.update(safetensors_io.load_file(os.path.join(path, shard)))
        return out
    if os.path.exists(os.path.join(path, "pytorch_model.bin")):
        return torch.load(os.path.join(path, "pytorch_model.bin"),
                          map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"{path}: no model.safetensors, model.safetensors.index.json or "
        "pytorch_model.bin (remote hub loading is unsupported)")


def load_hf_checkpoint(path: str | os.PathLike, *, device=None,
                       **config_overrides) -> tuple[ModelConfig, dict]:
    """Load a local HF LLaMA-family checkpoint directory: returns
    (ModelConfig, params), the leaves at the config's param_dtype on
    `device` (the card unless named).

    `config_overrides` go to ModelConfig (e.g. dtype="float32",
    attention_impl="flash"); structural ones must agree with the
    checkpoint (config_from_hf)."""
    path = os.fspath(path)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, **config_overrides)
    return cfg, params_from_hf(read_hf_state_dict(path), cfg, device=device)
