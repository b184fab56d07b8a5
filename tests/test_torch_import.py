"""The port imports neither JAX nor the JAX package, nor ``ml_dtypes``.

A fresh interpreter imports every module of ``repro_torch`` and
``chip_smoke.py`` and reports the modules then loaded; none may be
``jax*``, ``ml_dtypes`` or ``repro`` / ``repro.*`` (the card's machine has
no ``ml_dtypes``: the checkpoint moves bf16 bytes through an int16 view).  ``chip_smoke.py`` imports lazily,
inside its phases, so its import statements are also read from its source.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

PROBE = """
import importlib, json, pkgutil, sys
import chip_smoke
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(ROOT), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    # every subpackage of the slice was imported
    for mod in ("repro_torch.amg.distributed", "repro_torch.core.cache",
                "repro_torch.kernels.spmv_ell.cuda",
                "repro_torch.sparse.device", "repro_torch.obs.spans",
                "repro_torch.kernels.build",
                "repro_torch.kernels.moe_pack.cuda",
                "repro_torch.kernels.flash_attention.cuda",
                "repro_torch.core.dynexchange", "repro_torch.configs",
                "repro_torch.configs.deepseek_v2_lite_16b",
                "repro_torch.models.common", "repro_torch.models.attention",
                "repro_torch.models.blocks", "repro_torch.models.moe",
                "repro_torch.models.lm", "repro_torch.models.convert",
                "repro_torch.models.serving", "repro_torch.serve.engine",
                "repro_torch.configs.zamba2_7b",
                "repro_torch.configs.mamba2_780m", "repro_torch.models.ssm",
                "repro_torch.configs.qwen2_0_5b",
                "repro_torch.configs.qwen1_5_0_5b",
                "repro_torch.configs.gemma3_1b",
                "repro_torch.configs.nemotron_4_15b",
                "repro_torch.configs.qwen2_vl_2b",
                "repro_torch.kernels.ssd_scan.cuda",
                "repro_torch.obs.metrics", "repro_torch.obs.export",
                "repro_torch.profile.trace",
                "repro_torch.profile.calibrate",
                "repro_torch.profile.adapt",
                "repro_torch.runtime.controller",
                "repro_torch.runtime.elastic",
                "repro_torch.runtime.straggler",
                "repro_torch.runtime.checkpoint",
                "repro_torch.verify.invariants",
                "repro_torch.verify.executor_audit",
                "repro_torch.verify.kernel_budget",
                "repro_torch.train", "repro_torch.train.optimizer",
                "repro_torch.train.compression", "repro_torch.train.data",
                "repro_torch.train.trainer", "repro_torch.train.tree",
                "repro_torch.launch", "repro_torch.launch.train"):
        assert mod in report["imported"]
    assert "chip_smoke" in report["loaded"]
    assert [m for m in report["loaded"] if _reference(m)] == []


def _reference(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def test_chip_smoke_imports_no_jax_and_no_reference_package():
    """Every import statement of chip_smoke.py, at any depth."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert "repro_torch.serve" in names and "torch" in names
    assert [n for n in names if _reference(n)] == []


def test_decode_ab_imports_no_jax_and_no_reference_package():
    """Every import statement of decode_ab.py, the decode-step A/B."""
    tree = ast.parse((ROOT / "decode_ab.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert "chip_smoke" in names and "repro_torch.serve" in names
    assert [n for n in names if _reference(n)] == []
