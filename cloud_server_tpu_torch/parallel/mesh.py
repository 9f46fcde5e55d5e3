"""Device mesh construction.

The port's counterpart of the reference's one canonical mesh, axes (dp,
pp, fsdp, ep, sp, tp) — see `MeshConfig`. A mesh here is a
`torch.distributed` `DeviceMesh` over the ranks of the process group,
one device a rank, with the reference's axis names in its order, so
tensor parallelism (tp) is the innermost axis: its ranks are adjacent
(on one host, joined by NVLink). Axes of size 1 are kept (they are
free), so code never special-cases a missing axis. The caller
initializes the process group first (`parallel.distributed.initialize`,
or `torchrun`'s environment); its backend is the mesh's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from cloud_server_tpu_torch.config import MeshConfig

_CURRENT_MESH: DeviceMesh | None = None


def set_current_mesh(mesh: DeviceMesh | None) -> DeviceMesh | None:
    """Register the process-wide mesh (None clears it)."""
    global _CURRENT_MESH
    _CURRENT_MESH = mesh
    return mesh


def current_mesh() -> DeviceMesh:
    if _CURRENT_MESH is None:
        raise RuntimeError(
            "no mesh registered — build one with make_mesh() (it registers "
            "itself) or call set_current_mesh()")
    return _CURRENT_MESH


def maybe_current_mesh() -> DeviceMesh | None:
    """current_mesh() for callers that degrade gracefully without one."""
    return _CURRENT_MESH


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _build(device_type: str, ranks: torch.Tensor) -> DeviceMesh:
    """A DeviceMesh over `ranks` (shaped like the mesh), axes named in
    the canonical order; registered as the current mesh."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.distributed.initialize() (or "
            "run under torchrun) before building a mesh")
    return set_current_mesh(DeviceMesh(device_type, ranks,
                                       mesh_dim_names=MeshConfig.AXIS_ORDER))


def make_mesh(cfg: MeshConfig, device_type: str = "cuda") -> DeviceMesh:
    """Build a named mesh with canonical axis order from a MeshConfig
    over the first cfg.num_devices ranks. Every rank of the process
    group calls it (it makes one process group per mesh dimension).
    `device_type` is "cuda" (one card a rank, selected with
    torch.cuda.set_device before) or "cpu"."""
    n = cfg.num_devices
    have = world_size()
    if n > have:
        raise ValueError(
            f"MeshConfig wants {n} devices but only {have} available")
    shape = tuple(cfg.axis_sizes()[a] for a in MeshConfig.AXIS_ORDER)
    return _build(device_type, torch.arange(n).reshape(shape))


def mesh_for_devices(n_devices: int, *, tp: int = 1, sp: int = 1,
                     pp: int = 1, ep: int = 1, dp: int = 1,
                     device_type: str = "cuda") -> DeviceMesh:
    """Convenience: put every explicitly-requested axis in place and absorb
    the remaining device count into fsdp."""
    used = tp * sp * pp * ep * dp
    if n_devices % used != 0:
        raise ValueError(f"{n_devices} devices not divisible by {used}")
    cfg = MeshConfig(dp=dp, pp=pp, fsdp=n_devices // used, ep=ep, sp=sp,
                     tp=tp)
    return make_mesh(cfg, device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of the mesh's `axis` (1 for a name it lacks)."""
    names = mesh.mesh_dim_names or ()
    return int(mesh.shape[names.index(axis)]) if axis in names else 1
