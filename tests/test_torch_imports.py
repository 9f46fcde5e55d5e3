"""The port stands alone: no module of cloud_server_tpu_torch, and not
chip_smoke.py, imports jax, jaxlib or the reference package — checked on
the source (AST) and at run time in a fresh interpreter."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cloud_server_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cloud_server_tpu")
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_every_training_module_is_checked():
    """The training slices' modules are among those both checks cover."""
    mods = set(_modules())
    for m in ("ops.flash_attention", "training.optim", "training.train_step",
              "training.loop", "train", "data.dataset", "data.loader",
              "utils.metrics", "utils.logging", "utils.failure",
              "ops.fused_ce", "training.eval", "training.checkpoint",
              "utils.prng", "ops.matmul", "generate"):
        assert f"cloud_server_tpu_torch.{m}" in mods, m


def test_every_serving_module_is_checked():
    """The serving slices' modules, the HTTP frontend, the host policy
    layer, the profiler window, the replica router, multi-LoRA serving
    and the scenario harness among them, are among those both checks
    cover."""
    mods = set(_modules())
    for m in ("ops.paged_attention", "ops.attention", "inference.engine",
              "inference.paged_engine", "inference.paged_server",
              "inference.server", "inference.http_server",
              "inference.iteration_profile", "inference.request_trace",
              "inference.qos", "inference.slo", "inference.faults",
              "inference.anomaly", "inference.migration",
              "inference.router", "inference.multi_lora", "models.lora",
              "scenarios", "scenarios.workload", "scenarios.replay",
              "scenarios.simulator", "scenarios.autoscaler",
              "utils.tracing", "utils.serving_metrics", "utils.logging",
              "generate"):
        assert f"cloud_server_tpu_torch.{m}" in mods, m


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
