"""``chip_smoke.run`` rehearsed on the CPU at a tiny size.

On the card it builds the kernels and drives the main path; here its whole
control flow runs on the CPU with the plain versions (no kernel launches,
so no device numbers), so that a change to the port that breaks the chip
smoke shows up before a chip run.
"""
import pathlib
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_chip_smoke_phases_run_on_cpu():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    res = chip_smoke.run("cpu", rows=4096, block_cols=16, v_cycles=2)
    assert set(res["kernels"]) == {
        "spmv_ell", "spmv_ell_blocked", "spmv_ell_blocked_partial",
        "spmv_ell_blocked_skip",
    }
    for rec in res["kernels"].values():
        assert rec["max_abs_err"] == 0.0          # the plain version itself
        assert rec["bound_ms"] > 0.0 and rec["bound_by"] == "bytes"
    assert set(res["solves"]) == set(chip_smoke.SOLVES)
    assert all(n == 0 for n in res["launches"].values())   # no card

