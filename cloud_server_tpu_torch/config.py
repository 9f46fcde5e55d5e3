"""Typed configuration system.

Plain frozen dataclasses so configs are hashable and serialise cleanly
to/from JSON. A copy of the reference package's `config.py`: the same
fields, defaults and JSON round trip, so one config file drives both
implementations. Fields that select features the port does not run yet
are kept (so configs round-trip) and rejected where they are used.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer family configuration."""

    vocab_size: int = 32000
    embed_dim: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 16  # < num_heads => grouped-query attention
    head_dim: int = 128
    mlp_dim: int = 8192
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    # RoPE frequency scaling for long-context checkpoints:
    # "none" | "linear" (divide all frequencies by factor) | "llama3"
    # (Llama 3.1 band-wise interpolation; see ops/rope.py:_scale_inv_freq)
    rope_scaling: str = "none"
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_len: int = 8192
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # master parameter dtype
    # attention implementation: "xla" | "flash" | "ring" | "ulysses"
    # ("ring" and "ulysses" are the two sequence-parallel schemes over sp:
    #  ppermute kv rotation vs all-to-all head re-sharding)
    attention_impl: str = "xla"
    # flash-attention block sizes (the training kernel's q/kv tiling;
    # not ported yet)
    flash_block_q: int = 1024
    flash_block_kv: int = 1024
    # decode-time (cached) attention: "xla" | "pallas". The names are the
    # reference's. In the port "pallas" selects the hand-written CUDA
    # paged-attention kernel (ops/paged_attention.py) and "xla" the plain
    # PyTorch gather + attention.
    decode_attention_impl: str = "xla"
    # KV-cache storage: "model" (cfg.dtype) | "int8" (symmetric
    # per-(position, head) absmax quantization — halves cache memory;
    # scales fold into the attention einsums / kernel rows, so no
    # dequantized cache copy is ever materialised)
    kv_cache_dtype: str = "model"
    # mixture of experts (0 experts => dense MLP)
    num_experts: int = 0
    num_experts_per_token: int = 2
    expert_capacity_factor: float = 1.25
    # rematerialisation policy for the layer scan:
    # "none" | "full" | "dots" | "attn" (save only flash-attention residuals)
    remat: str = "full"
    # layer-scan unroll factor of the reference's compiled stack; the
    # port runs layers in an eager Python loop and ignores it
    scan_layers_unroll: int = 1
    logits_softcap: float = 0.0
    # Training-loss vocab chunk size. 0 = dense path (materialise the full
    # (B, S, V) f32 logits). >0 = fused blockwise CE: the unembed matmul,
    # softcap and logsumexp run one vocab chunk at a time inside a
    # rematerialised scan, so peak loss-path memory is (B, S, chunk) and
    # the ~1 GB logits tensor never hits HBM.
    vocab_chunk: int = 0
    # Training-loss implementation:
    #   "dense"  — materialise (B, S, V) f32 logits (XLA path);
    #              vocab_chunk > 0 selects the scan-chunked variant.
    #   "pallas" — ops/fused_ce.py kernels: online-logsumexp forward
    #              (no logits in HBM), single-recompute backward whose
    #              one (B*S, V) buffer is the MODEL-dtype d_logits —
    #              half the dense path's f32 logits — with gradient
    #              matmuls in the model dtype. Requires
    #              logits_softcap == 0 and B*S, vocab divisible by 128.
    ce_impl: str = "dense"

    def __post_init__(self) -> None:
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"num_heads={self.num_heads} must be a multiple of "
                f"num_kv_heads={self.num_kv_heads}"
            )
        if self.ce_impl not in ("dense", "pallas"):
            raise ValueError(f"unknown ce_impl: {self.ce_impl!r}")
        if self.ce_impl == "pallas" and self.logits_softcap != 0.0:
            raise ValueError(
                "ce_impl='pallas' does not implement logits_softcap; "
                "use the dense/chunked CE path")
        if self.ce_impl == "pallas" and self.vocab_chunk > 0:
            raise ValueError(
                "ce_impl='pallas' and vocab_chunk are mutually "
                "exclusive CE implementations")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. Axis sizes of 1 are always legal.

    Canonical axis order (outer→inner, DCN-friendly outer, ICI-friendly
    inner): dp, pp, fsdp, ep, sp, tp. Tensor parallelism is innermost so its
    collectives ride the fastest ICI links.
    """

    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    AXIS_ORDER = ("dp", "pp", "fsdp", "ep", "sp", "tp")

    @property
    def num_devices(self) -> int:
        n = 1
        for a in self.AXIS_ORDER:
            n *= getattr(self, a)
        return n

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in self.AXIS_ORDER}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    # "warmup_cosine" | "wsd" (warmup-stable-decay: hold peak, then a
    # linear cooldown over the last lr_decay_frac of training — the
    # schedule that lets one run branch into many cooldown lengths) |
    # "constant" (warmup then hold)
    lr_schedule: str = "warmup_cosine"
    lr_decay_frac: float = 0.1  # wsd cooldown fraction of total_steps
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip_norm: float = 1.0
    batch_size: int = 8  # global batch, in sequences
    microbatch_steps: int = 1  # gradient accumulation factor
    seq_len: int = 2048
    z_loss_coef: float = 0.0
    seed: int = 0
    moe_aux_loss_coef: float = 0.01
    moe_router_z_coef: float = 0.0
    # Exponential moving average of params (0 = disabled). The EMA tree
    # rides inside the optimizer state (sharded + checkpointed for free);
    # extract with training.optim.ema_params(state.opt_state).
    ema_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class InferConfig:
    max_decode_len: int = 256
    temperature: float = 1.0
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled
    eos_token_id: int = -1  # -1 => never stop early
    pad_token_id: int = 0
    # Paged-server scheduling under admission churn (the contiguous
    # server ignores both; PagedInferenceServer constructor arguments of
    # the same names override these defaults):
    #   "mixed" — stall-free token-budget batching: chunked prefills
    #     piggyback on decode batches in one ragged dispatch, so decode
    #     never stalls behind an admission (Sarathi-style).
    #   "alternating" — separate prefill-chunk and decode dispatches
    #     per scheduler step (the pre-mixed behavior; the fallback).
    scheduler: str = "mixed"
    # Async double-buffered scheduling (paged server, MIXED scheduler
    # only — the alternating scheduler always keeps its sequential
    # per-chunk loop; the contiguous server's simpler launch-ahead
    # decode pipelining is gated on this same knob). True (the
    # default) overlaps host policy work —
    # sweep, QoS/DRR admission, deadline checks, and the numpy
    # dispatch build — with the device executing the PREVIOUS
    # iteration's fused program: each step plans iteration N+1 against
    # the last committed ledger while iteration N runs, then pays only
    # the sanctioned device_get commit (+ a cheap ledger patch and the
    # next launch) on the serialized critical path. False restores the
    # byte-identical sequential loop (plan -> dispatch -> sync ->
    # commit per step, nothing in flight across steps). Constructor
    # argument `overlap=` / the CLI's `--no-overlap` override.
    overlap: bool = True
    # Tokens per mixed iteration: all live decode rows (times their
    # round count) plus however many prefill-chunk tokens fit. 0 = auto:
    # max_slots * (decode window * decode_chunk + prefill_chunk) —
    # effectively work-conserving; set lower to trade admission speed
    # for a per-iteration latency (ITL) bound.
    mixed_token_budget: int = 0
    # Scheduler flight recorder: how many per-iteration records the
    # paged server's ring buffer retains for /stats post-mortems
    # (token-budget utilization, prefill/decode split, occupancy,
    # compaction, preemptions). Constructor argument of the same name
    # overrides; records are small dicts, so even thousands are cheap.
    flight_recorder_size: int = 256
    # Multi-tenant QoS (inference/qos.py): a JSON object as a string,
    # or a path to a JSON file, declaring per-tenant weights, priority
    # classes, token-bucket rate limits, and pending bounds (schema in
    # docs/serving.md). "" (the default) disables QoS entirely — the
    # schedulers run the byte-identical single-tenant FIFO paths. A
    # string (not a dict) keeps this dataclass hashable for jit static
    # arguments; servers parse it at construction. Constructor argument
    # `qos=` overrides.
    qos_config: str = ""
    # Per-request distributed tracing (inference/request_trace.py):
    # head-based sampling probability in [0, 1]. 0.0 (the default)
    # disables tracing entirely — the schedulers run the byte-identical
    # pre-trace paths. Sampled requests carry a span tree (queue /
    # prefill / decode / preempt_gap / emit phases plus per-iteration
    # scheduler spans) retrievable via GET /debug/requests/<id> and
    # exported Chrome-trace-style via GET /traces; W3C `traceparent`
    # headers propagate in and out. Constructor argument `tracing=`
    # (a rate or a ready TraceRecorder) overrides.
    trace_sample_rate: float = 0.0
    # Finished-trace ring capacity: how many completed head-sampled
    # span trees the recorder retains for GET /traces and
    # GET /debug/requests/<id> (oldest evicted). Previously hardcoded
    # at 256 inside the recorder. Constructor argument `tracing=` with
    # a ready TraceRecorder overrides.
    trace_capacity: int = 256
    # Tail-based trace retention: capacity of the SEPARATE bounded
    # ring that keeps the span trees of requests that proved anomalous
    # at finish (failed / deadline-expired / cancelled, migrated or
    # retried, missed their class SLO target, preempted repeatedly, or
    # finished inside an open anomaly window) even when head sampling
    # skipped them — the "1% sampling, broken requests always
    # inspectable" mode. 0 (the default) disables tail retention
    # entirely (no provisional traces, byte-identical pre-tail
    # serving).
    trace_tail_capacity: int = 0
    # Adaptive speculative decoding (inference/spec_control.py): a JSON
    # object as a string, or a path to a JSON file, with the controller
    # knobs (low/high accept-rate hysteresis thresholds, ewma, cooldown,
    # probe_period, initial draft length — schema in the module
    # docstring and docs/serving.md). "" (the default) enables the
    # DEFAULT adaptive controller whenever speculation is configured
    # (spec_drafts > 0); the literal "off" pins the fixed spec_drafts
    # draft length (the pre-adaptive behavior). A string keeps this
    # dataclass hashable for jit static arguments; the paged server
    # parses it at construction. Constructor argument `spec_control=`
    # (a config, a ready SpecController, or False) overrides.
    spec_control_config: str = ""
    # Iteration-phase profiler (inference/iteration_profile.py): stamp
    # every scheduler iteration's phase boundaries (sweep / admission /
    # build / device / commit / epilogue) with a bounded number of
    # perf_counter reads — zero added dispatches or syncs. Feeds the
    # flight recorder (`phases_ms`, `host_ms`, `device_wait_ms`,
    # `host_gap_frac`), the `cloud_server_iter_phase_ms` histograms,
    # the /stats `iteration_profile` summary, and the
    # GET /debug/scheduler_trace Perfetto export. False restores the
    # exact pre-profiler clock behavior (two reads per busy
    # iteration). Constructor argument `iteration_profile=` overrides.
    iteration_profile: bool = True
    # Per-class SLO targets (inference/slo.py): a JSON object as a
    # string, or a path to a JSON file, declaring per-priority-class
    # latency targets (ttft/itl/queue_wait/e2e) and attainment
    # objectives plus the rolling windows (schema in the module
    # docstring; surfaced via GET /slo and the slo_attainment /
    # slo_burn_rate gauges). "" (the default) disables SLO tracking
    # entirely. A string keeps this dataclass hashable for jit static
    # arguments; servers parse it at construction. Constructor
    # argument `slo=` overrides.
    slo_config: str = ""
    # Deterministic fault injection (inference/faults.py): a JSON
    # object as a string, or a path to a JSON file, arming named fault
    # sites (submit_reject / dispatch / iteration_stall / wedge /
    # alloc_famine) with seeded after/count/p windows — the lever that
    # makes every recovery path (router failover, breakers, _fail_all)
    # provable instead of aspirational. "" (the default) disables
    # injection entirely: every guarded call site short-circuits and
    # the schedulers run the byte-identical pre-fault paths (pinned by
    # the dispatch/device_get-count regression clones). A string keeps
    # this dataclass hashable for jit static arguments; servers parse
    # it at construction. Constructor argument `faults=` overrides.
    fault_plan: str = ""
    # Overload brownout (inference/faults.py): a JSON object as a
    # string, or a path to a JSON file, with the OverloadDetector
    # thresholds (pending_age_s / budget_utilization / host_gap_frac
    # EWMAs), hysteresis, shed sets per level, and the jittered
    # Retry-After base. "" (the default) disables brownout. Requires a
    # QoS registry (shed sets are priority classes). Paged server
    # only; constructor argument `brownout=` overrides.
    brownout_config: str = ""
    # Anomaly watchdog (inference/anomaly.py): a JSON object as a
    # string, or a path to a JSON file, with the rule thresholds
    # (slo_burn / latency_shift / cache_collapse / breaker_flap /
    # deadline_spike / preempt_spike / host_gap / wedged), hysteresis
    # hold, warm-up, and optional auto-capture knobs (schema in the
    # module docstring). "" (the default) disables the watchdog
    # entirely: every guarded call site short-circuits and the
    # schedulers run the byte-identical pre-watchdog paths.
    # Constructor argument `anomaly=` overrides.
    anomaly_config: str = ""
    # Auto-capture a forensic debug bundle (the GET /debug/bundle
    # artifact: metrics, flight window, retained traces, cache/SLO/
    # brownout/anomaly state) into a bounded ring each time a watchdog
    # rule activates. Requires anomaly_config; off by default.
    bundle_on_anomaly: bool = False

    def __post_init__(self) -> None:
        if self.scheduler not in ("mixed", "alternating"):
            raise ValueError(f"unknown scheduler: {self.scheduler!r}")
        if self.flight_recorder_size <= 0:
            raise ValueError("flight_recorder_size must be positive")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError("trace_sample_rate must be in [0, 1]")
        if self.trace_capacity <= 0:
            raise ValueError("trace_capacity must be positive")
        if self.trace_tail_capacity < 0:
            raise ValueError("trace_tail_capacity must be >= 0")


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)


def from_json(cls: type, payload: str | Mapping[str, Any]):
    data = json.loads(payload) if isinstance(payload, str) else dict(payload)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in fields})
