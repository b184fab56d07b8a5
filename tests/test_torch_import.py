"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``repro_torch`` and reports the
modules then loaded; none may be ``jax*`` or ``repro`` / ``repro.*``.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    # every subpackage of the slice was imported
    for mod in ("repro_torch.amg.distributed", "repro_torch.core.cache",
                "repro_torch.kernels.spmv_ell.cuda",
                "repro_torch.sparse.device", "repro_torch.obs.spans"):
        assert mod in report["imported"]
    bad = [m for m in report["loaded"]
           if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "repro" or m.startswith("repro.")]
    assert bad == []
