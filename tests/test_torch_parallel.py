"""The port's `parallel/` package against the reference's: mesh shapes,
layouts and errors (tests/test_distributed.py's), the single-process
coordination helpers, the sharding rules and every parameter's spec,
`shard_params` slices that concatenate back to the whole tree, each
collective on a 2-rank gloo group against numpy, and `spawn_ranks`'
failure path. The multi-rank checks run `tests/torch_tp_ranks.py`
(torch only) in one 4-rank spawn."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import MeshConfig as RefMeshConfig
from cloud_server_tpu.config import ModelConfig as RefModelConfig
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu.parallel import distributed as ref_dist
from cloud_server_tpu.parallel import sharding as ref_sharding
from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.parallel import distributed as pdist
from cloud_server_tpu_torch.parallel import sharding
from cloud_server_tpu_torch.parallel import spawn_ranks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_ranks as ranks  # noqa: E402
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

_CFG = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=8, mlp_dim=64, max_seq_len=32,
            dtype="float32", param_dtype="float32", remat="none")


@pytest.fixture(scope="module")
def four_ranks():
    return spawn_ranks(ranks.parallel_checks, 4, "gloo", deadline_s=180.0)


def test_mesh_shapes_and_layouts_match_reference(four_ranks):
    """A (dp 2, tp 2) mesh and the hybrid mesh (tp 2 on a host, dp 2
    across): the reference's axis names, sizes and device (rank) layout
    on the same number of devices."""
    devs = jax.devices()[:4]
    ref = ref_dist.make_hybrid_mesh(RefMeshConfig(tp=2), RefMeshConfig(dp=2),
                                    devices=devs)
    ids = np.vectorize(lambda d: devs.index(d))(ref.devices).tolist()
    for res in four_ranks:
        names, shape, layout = res["hybrid"]
        assert dict(zip(names, shape)) == dict(ref.shape)
        assert layout == ids
        names, shape, layout = res["full"]
        assert names == RefMeshConfig.AXIS_ORDER
        assert shape == (2, 1, 1, 1, 1, 2)
        assert layout == np.arange(4).reshape(shape).tolist()
    assert [r["tp_local_rank"] for r in four_ranks] == [0, 1, 0, 1]


def test_mesh_errors_match_reference(four_ranks):
    """Too many devices, a DCN axis other than dp/pp, and a hybrid mesh
    of the wrong size: the reference's ValueErrors."""
    res = four_ranks[0]
    assert res["too_many"] == ("MeshConfig wants 8 devices but only 4 "
                               "available")
    with pytest.raises(ValueError, match="keep DCN to dp/pp") as ref_err:
        ref_dist.make_hybrid_mesh(RefMeshConfig(dp=2), RefMeshConfig(tp=2))
    assert res["dcn_tp"] == str(ref_err.value)
    assert res["hybrid_size"] == "hybrid mesh wants 2×4=8 devices, got 4"


def _other(rank):
    return rank ^ 1  # the other member of a rank's tp group


def test_collectives_match_numpy(four_ranks):
    """Each collective on a mesh's 2-rank tp group, against numpy."""
    def x(rank):
        return np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * rank

    for rank, res in enumerate(four_ranks):
        me, other = x(rank), x(_other(rank))
        lo, hi = (me, other) if rank % 2 == 0 else (other, me)
        local = rank % 2
        total = me + other
        np.testing.assert_array_equal(res["psum"], total)
        np.testing.assert_array_equal(res["pmean"], total / 2)
        np.testing.assert_array_equal(res["all_gather0"],
                                      np.concatenate([lo, hi], 0))
        np.testing.assert_array_equal(res["all_gather1"],
                                      np.concatenate([lo, hi], 1))
        np.testing.assert_array_equal(res["reduce_scatter0"],
                                      np.split(total, 2, 0)[local])
        np.testing.assert_array_equal(res["reduce_scatter1"],
                                      np.split(total, 2, 1)[local])
        np.testing.assert_array_equal(res["ppermute"], other)
        np.testing.assert_array_equal(res["ppermute_back"], other)
        np.testing.assert_array_equal(res["all_to_all"], np.concatenate(
            [np.split(lo, 2, 0)[local], np.split(hi, 2, 0)[local]], 1))
        np.testing.assert_array_equal(res["ring"], other + 1)
        assert res["pvary_is_identity"]


def test_multi_rank_coordination_helpers(four_ranks):
    for rank, res in enumerate(four_ranks):
        assert res["broadcast"] == {"rank": 0}
        assert res["is_primary"] == (rank == 0)
        assert res["num_slices"] == 1
        s = res["summary"]
        assert (s["process_index"], s["process_count"], s["backend"],
                s["global_devices"]) == (rank, 4, "gloo", 4)


def test_single_process_coordination_helpers():
    """As the reference's: no process group, one process."""
    assert pdist.is_primary()
    assert pdist.num_slices() == 1
    pdist.sync_global_devices("test")  # no-op, must not raise
    tree = {"a": np.arange(3), "b": 7}
    out = pdist.broadcast_from_primary(tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    summary = pdist.process_env_summary()
    assert summary["process_count"] == 1
    assert summary["global_devices"] == 1


def test_global_mesh_config():
    g = pdist.global_mesh_config(RefMeshConfig(fsdp=2, tp=2),
                                 RefMeshConfig(dp=2))
    want = ref_dist.global_mesh_config(RefMeshConfig(fsdp=2, tp=2),
                                       RefMeshConfig(dp=2))
    assert g.axis_sizes() == want.axis_sizes() and g.num_devices == 8


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_rules_and_specs_match_reference(tie):
    """DEFAULT_RULES, `param_logical_axes` and `spec_from_logical` of every
    leaf equal the reference's."""
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES
    ref_axes = ref_transformer.param_logical_axes(
        RefModelConfig(**_CFG, tie_embeddings=tie))
    axes = transformer.param_logical_axes(ModelConfig(**_CFG,
                                                      tie_embeddings=tie))
    assert axes == ref_axes
    for group, leaves in axes.items():
        for name, leaf in leaves.items():
            assert sharding.spec_from_logical(leaf) == tuple(
                ref_sharding.spec_from_logical(ref_axes[group][name])), name
    x = object()
    assert sharding.constrain(x, ("batch", None)) is x


class _Mesh:
    """The two DeviceMesh reads `parallel.sharding` makes, for one rank of
    a (fsdp, tp) mesh, in one process."""

    mesh_dim_names = ("dp", "pp", "fsdp", "ep", "sp", "tp")

    def __init__(self, fsdp: int, tp: int, rank: int):
        self.shape = (1, 1, fsdp, 1, 1, tp)
        self._local = {"fsdp": rank // tp, "tp": rank % tp}

    def get_local_rank(self, axis):
        return self._local.get(axis, 0)


def _splits_of(axes, fsdp, tp):
    return {dim: [a for a in (spec if isinstance(spec, tuple) else (spec,))
                  if {"fsdp": fsdp, "tp": tp}.get(a, 1) > 1]
            for dim, spec in enumerate(sharding.spec_from_logical(axes))}


@pytest.mark.parametrize("fsdp,tp", [(1, 2), (1, 4), (2, 2)])
def test_shard_params_concatenate_back(fsdp, tp):
    """Every rank's `shard_params` slices of a parameter tree reassemble
    the whole tree (rank-major over fsdp then tp); replicated leaves are
    kept as they are; a split that does not divide raises."""
    cfg = ModelConfig(**{**_CFG, "num_kv_heads": 4})
    params = transformer.init_params(cfg, 0, device="cpu")
    axes = transformer.param_logical_axes(cfg)
    shards = [sharding.shard_params(params, axes, _Mesh(fsdp, tp, r))
              for r in range(fsdp * tp)]
    for group, leaves in params.items():
        for name, full in leaves.items():
            splits = _splits_of(axes[group][name], fsdp, tp)
            pieces = [s[group][name] for s in shards]
            split_dims = {d: a for d, al in splits.items() for a in al}
            if not split_dims:
                assert all(p is full for p in pieces), name
                continue
            grid = np.empty((fsdp, tp), dtype=object)
            for r, p in enumerate(pieces):
                grid[r // tp, r % tp] = p
            dims = {a: d for d, a in split_dims.items()}
            rows = [torch.cat(list(grid[i]), dim=dims["tp"])
                    if "tp" in dims else grid[i, 0] for i in range(fsdp)]
            whole = (torch.cat(rows, dim=dims["fsdp"]) if "fsdp" in dims
                     else rows[0])
            torch.testing.assert_close(whole, full, rtol=0, atol=0)
    want = {"embed": {"tokens": ((0, "tp"),) + (((1, "fsdp"),)
                                                if fsdp > 1 else ())}}
    got = sharding.logical_to_sharding({"embed": axes["embed"]},
                                       _Mesh(fsdp, tp, 0))
    assert got == want
    with pytest.raises(ValueError, match="does not split evenly"):
        sharding.shard_tensor(torch.zeros(3, 4), ((0, "tp"),),
                              _Mesh(1, 2, 0))


def test_spawn_ranks_raises_a_failed_ranks_error():
    """A rank that raises: the others are killed and spawn_ranks raises
    with the failed rank's traceback (a run that succeeds returns each
    rank's result: the four_ranks fixture)."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn_ranks(ranks.spawn_probe, 2, "gloo", 1, deadline_s=120.0)
