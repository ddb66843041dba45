"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` brings in neither JAX nor the reference package, and
builds or loads no CUDA code."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                      # guarded by __main__: does not run
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "torch.utils.cpp_extension" not in sys.modules
from repro_torch.kernels import cuda_build
assert not cuda_build._loaded
for name in ("repro_torch.kernels.ssd_scan.ops", "repro_torch.models.ssm_model",
             "repro_torch.serving.engine", "repro_torch.launch.serve",
             "repro_torch.kernels.flash_attention.ops",
             "repro_torch.kernels.flash_attention.ref",
             "repro_torch.configs.llama3_2_3b", "repro_torch.models.rope",
             "repro_torch.models.mlp", "repro_torch.models.attention",
             "repro_torch.models.transformer", "repro_torch.rl.dqn",
             "repro_torch.benchmarks.common",
             "repro_torch.benchmarks.group_outcomes",
             "repro_torch.benchmarks.paper_fig2_a2c",
             "repro_torch.benchmarks.paper_fig5_dqn",
             "repro_torch.benchmarks.paper_fig34_scaling",
             "repro_torch.examples.quickstart",
             "repro_torch.examples.heterogeneous_group",
             "repro_torch.checkpoint.npz", "repro_torch.core.chaos",
             "repro_torch.core.transport", "repro_torch.core.group_mdp",
             "repro_torch.serving.api", "repro_torch.serving.continuous",
             "repro_torch.serving.group", "repro_torch.serving.metrics",
             "repro_torch.benchmarks.bench_serving",
             "repro_torch.examples.continuous_serving",
             "repro_torch.examples.serve_batch",
             "repro_torch.core.sharded_ddal", "repro_torch.data.synthetic",
             "repro_torch.launch.train",
             "repro_torch.examples.group_train_llm",
             "repro_torch.kernels.plain_vjp",
             "repro_torch.models.hybrid", "repro_torch.configs.zamba2_7b",
             "repro_torch.configs.qwen2_7b",
             "repro_torch.configs.granite_3_8b",
             "repro_torch.configs.yi_34b", "repro_torch.models.moe",
             "repro_torch.configs.qwen3_moe_30b_a3b",
             "repro_torch.configs.deepseek_v2_lite_16b",
             "repro_torch.launch.dryrun_lib", "repro_torch.launch.dryrun",
             "repro_torch.roofline", "repro_torch.roofline.constants",
             "repro_torch.roofline.report",
             "repro_torch.roofline.collectives",
             "repro_torch.roofline.trace"):
    assert name in names, name
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    res = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 60


def test_no_jax_or_reference_import_lines_in_the_port():
    """The acceptance grep: no line of the port or of chip_smoke.py
    imports jax or the reference package."""
    import re
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                     r"from repro\.|from repro import)")
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits
