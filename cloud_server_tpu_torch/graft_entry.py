"""The port's counterpart of the repository root's `__graft_entry__`:
`entry`, a forward step on the flagship dense LM at its fixed config,
one card; and `dryrun_multichip`, one sharded step of each parallelism
family over n ranks.

`entry(device=None)` returns `(fn, (params, tokens))`: `fn` is the
port's `models.transformer.forward`, bound to the config (V 32000,
D 1024, 8 layers, 8 heads, 8 KV heads, Dh 128, F 4096, max_seq_len
1024; the rest ModelConfig's defaults, as the reference's), `params`
drawn from seed 0 and `tokens` zeros (2, 256) int64. It runs on the card
unless the caller asks for the CPU (`device="cpu"`).

    fn, args = entry()
    with torch.no_grad():
        logits = fn(*args)   # (2, 256, 32000) float32

`dryrun_multichip(n, device=None)` starts n ranks
(`parallel.spawn_ranks`: NCCL, one card a rank, or gloo with
`device="cpu"`) and runs the reference's eight families on them, one
step each on a tiny model: dense dp/fsdp/tp, ring sp, Ulysses sp, MoE
over ep, a hybrid mesh with dp across hosts, the pipeline over pp,
tensor-parallel paged serving with n-gram speculation (2 drafts), and
the two-replica router; then the reference's `ran` / `SKIPPED` line.
With fewer cards than n it raises; `share_card=True` puts the ranks on
the visible cards in turn over gloo (several ranks on one card). The
reference's tiny model has head_dim 16; the port's paged kernels take
64 and 128, so on the card the model has head_dim 64 (and the serving
family bfloat16 weights), and family 6 runs the paged kernels B1/B2.
The port's tensor-parallel server shards over tp alone (fsdp on a
server is not ported), so family 6's mesh is tp over every rank.
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


def _tiny_model(device_type: str, **overrides):
    from cloud_server_tpu_torch.config import ModelConfig
    base = dict(
        vocab_size=256, embed_dim=64, num_layers=2, num_heads=4,
        num_kv_heads=4, head_dim=16 if device_type == "cpu" else 64,
        mlp_dim=128, max_seq_len=64, dtype="float32",
        param_dtype="float32", remat="full")
    base.update(overrides)
    return ModelConfig(**base)


def _half_split(n: int) -> tuple:
    a = 2 if n % 2 == 0 else 1
    return a, n // a


def _run_one(tag, model_cfg, mesh, device, *, rules=None, loss_fn=None,
             loss_fn_module=None, batch_size=8, seq_len=32) -> str:
    """One sharded train step on `mesh`; its summary line."""
    import math

    import torch

    from cloud_server_tpu_torch.config import TrainConfig
    from cloud_server_tpu_torch.data.loader import batch_layout
    from cloud_server_tpu_torch.training import (init_train_state,
                                                 make_train_step)
    from cloud_server_tpu_torch.training.train_step import mesh_config_of

    train_cfg = TrainConfig(batch_size=batch_size, seq_len=seq_len,
                            warmup_steps=1, total_steps=2)
    state = init_train_state(model_cfg, train_cfg, 0, device, loss_fn_module,
                             mesh=mesh, rules=rules)
    step = make_train_step(model_cfg, train_cfg, mesh=mesh, rules=rules,
                           loss_fn=loss_fn, loss_fn_module=loss_fn_module)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, model_cfg.vocab_size, (batch_size, seq_len),
                           generator=gen)
    lay = batch_layout(mesh)
    i, n = lay["process_index"], lay["process_count"]
    j, m = lay["seq_shard"]
    b, s = batch_size // n, seq_len // m
    block = tokens[i * b:(i + 1) * b, j * s:(j + 1) * s].to(device)
    state, metrics = step(state, {"tokens": block})
    loss = float(metrics["loss"])
    assert state.step == 1 and math.isfinite(loss), (tag, loss)
    sizes = {k: v for k, v in mesh_config_of(mesh).axis_sizes().items()
             if v > 1}
    return f"dryrun[{tag}]: mesh={sizes or '{1 device}'} loss={loss:.4f}"


def _dryrun_rank(rank: int, world: int, device_type: str, cards: int,
                 backend: str) -> dict:
    """Every family on this rank, in the reference's order: the lines
    (rank 0's), and which families ran or were skipped."""
    import torch

    from cloud_server_tpu_torch.config import InferConfig, MeshConfig
    from cloud_server_tpu_torch.models import moe, transformer
    from cloud_server_tpu_torch.parallel import make_hybrid_mesh, make_mesh
    from cloud_server_tpu_torch.parallel.pipeline import (
        make_pipelined_loss, pipeline_rules)

    if device_type == "cuda":
        torch.cuda.set_device(rank % cards)
        device = torch.device("cuda", rank % cards)
    else:
        device = torch.device("cpu")
    n = world
    bs = 2 * n
    lines, ran, skipped = [], [], []
    paged_counts = {}

    def one(tag, cfg, axes, **kw):
        mesh = kw.pop("mesh", None) or make_mesh(MeshConfig(**axes),
                                                 device_type)
        lines.append(_run_one(tag, cfg, mesh, device, batch_size=bs, **kw))

    # 1. dense dp/fsdp/tp
    tp, rest = _half_split(n)
    fsdp, dp = _half_split(rest)
    one("dense dp/fsdp/tp", _tiny_model(device_type),
        {"dp": dp, "fsdp": fsdp, "tp": tp})
    ran.append("dense")
    # 2. ring attention over sp; 2b. Ulysses over sp
    sp, rest = _half_split(n)
    for impl, name in (("ring", "ring-sp"), ("ulysses", "ulysses-sp")):
        if sp > 1:
            one(f"{impl} sp", _tiny_model(device_type, attention_impl=impl),
                {"fsdp": rest, "sp": sp})
            ran.append(name)
        else:
            skipped.append(name)
    # 3. MoE over ep
    ep, rest = _half_split(n)
    if ep > 1:
        one("moe ep", _tiny_model(device_type, num_experts=4),
            {"fsdp": rest, "ep": ep}, loss_fn_module=moe)
        ran.append("moe-ep")
    else:
        skipped.append("moe-ep")
    # 4. hybrid mesh: dp across hosts, fsdp/tp inside one
    dcn_dp, rest = _half_split(n)
    if dcn_dp > 1:
        tp2, fsdp2 = _half_split(rest)
        mesh = make_hybrid_mesh(MeshConfig(fsdp=fsdp2, tp=tp2),
                                MeshConfig(dp=dcn_dp), device_type)
        one("hybrid dcn-dp", _tiny_model(device_type), {}, mesh=mesh)
        ran.append("hybrid-dcn")
    else:
        skipped.append("hybrid-dcn")
    # 5. pipeline over pp
    pp, rest = _half_split(n)
    if pp > 1:
        cfg = _tiny_model(device_type)
        mesh = make_mesh(MeshConfig(pp=pp, fsdp=rest), device_type)
        one("pipeline pp", cfg, {}, mesh=mesh, rules=pipeline_rules(),
            loss_fn=make_pipelined_loss(cfg, mesh, num_microbatches=2))
        ran.append("pipeline-pp")
    else:
        skipped.append("pipeline-pp")
    icfg = InferConfig(max_decode_len=4, temperature=0.0, eos_token_id=-1,
                       pad_token_id=0)
    serve_dtype = {} if device_type == "cpu" else {"dtype": "bfloat16"}
    # 6. tensor-parallel paged serving, n-gram speculation
    if n % 2 == 0:
        from cloud_server_tpu_torch.inference.paged_server import (
            PagedInferenceServer)
        cfg = _tiny_model(device_type, decode_attention_impl="pallas",
                          **serve_dtype)
        from cloud_server_tpu_torch.ops import paged_attention as pa
        mesh = make_mesh(MeshConfig(tp=n), device_type)
        params = transformer.init_params(cfg, 0, device=device)
        pa.reset_counters()
        srv = PagedInferenceServer(
            params, cfg, icfg, mesh=mesh, device=device,
            cuda_graphs=backend == "nccl", max_slots=2, max_context=32,
            page_size=8, prefill_chunk=8, prompt_buckets=[8],
            spec_drafts=2)
        if srv.tp_stats()["rank"] > 0:
            srv.follow()
        else:
            outs = srv.generate([[3, 7, 11], [9, 1, 4]], max_new_tokens=4)
            srv.stop()
            assert all(len(o) == 4 for o in outs), outs
            lines.append(f"dryrun[paged serving tp]: mesh={{'tp': {n}}} "
                         f"tokens={sum(len(o) for o in outs)}")
        paged_counts = pa.counters()
        ran.append("paged-serving-tp")
    else:
        skipped.append("paged-serving-tp")
    # 7. dp-replicated serving: two full replicas behind the router (rank
    # 0 runs it; greedy outputs bit-identical across replicas)
    if n >= 2:
        if rank == 0:
            from cloud_server_tpu_torch.inference.router import (
                ReplicatedRouter)
            cfg = _tiny_model(device_type, **serve_dtype)
            params = transformer.init_params(cfg, 0, device=device)
            devices = ([device, device] if device_type == "cpu" or cards < 2
                       else [torch.device("cuda", 0),
                             torch.device("cuda", 1)])
            router = ReplicatedRouter.over_devices(
                params, cfg, icfg, devices=devices, max_slots=2,
                max_context=32, page_size=8, prefill_chunk=8,
                prompt_buckets=[8])
            reqs = [router.submit([3, 7, 11], max_new_tokens=4)
                    for _ in range(4)]
            router.run_until_idle()
            outs = [r.tokens for r in reqs]
            assert all(o == outs[0] for o in outs), "replica outputs differ"
            per_replica = [r.tokens_emitted for r in router.replicas]
            assert all(k > 0 for k in per_replica), (
                f"router left a replica idle: {per_replica}")
            router.stop()
            lines.append(f"dryrun[replicated serving dp]: replicas=2 "
                         f"tokens/replica={per_replica} parity=exact")
        ran.append("replicated-serving-dp")
    else:
        skipped.append("replicated-serving-dp")
    msg = f"dryrun_multichip({n}): ran {ran}"
    if skipped:
        msg += f"; SKIPPED (n_devices odd/too small): {skipped}"
    lines.append(msg)
    return {"lines": lines, "ran": ran, "skipped": skipped,
            "paged_counts": paged_counts}


def dryrun_multichip(n_devices: int, device=None, *,
                     share_card: bool = False,
                     deadline_s: float = 600.0) -> dict:
    """One sharded step of each parallelism family over `n_devices`
    ranks (see the module docstring); prints rank 0's lines and returns
    {"lines", "ran", "skipped"} and "paged_counts", each rank's paged
    attention counters over family 6. On the cards (the default) each rank
    takes a card over NCCL, and fewer visible cards than ranks raise
    RuntimeError unless `share_card` (gloo, the ranks on the cards in
    turn); `device="cpu"` runs the ranks on the CPU over gloo."""
    import torch

    from cloud_server_tpu_torch import resolve_device
    from cloud_server_tpu_torch.parallel import spawn_ranks

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and cards < n_devices and not share_card:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} cards, "
            f"found {cards} (share_card=True runs the ranks on fewer "
            "cards over gloo)")
    backend = ("nccl" if dev.type == "cuda" and not share_card
               else "gloo")
    ranks = spawn_ranks(_dryrun_rank, n_devices, backend, dev.type, cards,
                        backend, deadline_s=deadline_s)
    out = {**ranks[0], "paged_counts": [r["paged_counts"] for r in ranks]}
    for line in out["lines"]:
        print(line, flush=True)
    return out
