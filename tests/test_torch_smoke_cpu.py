"""``chip_smoke`` rehearsed on the CPU at a tiny size.

On the card it builds the kernels and drives the main paths; here its whole
control flow runs on the CPU with the plain versions (no kernel launches,
so no device numbers), so that a change to the port that breaks the chip
smoke shows up before a chip run.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_phases_run_on_cpu():
    """Every AMG phase, the partitioned setup and solve (levels against the
    host hierarchy, the coarse allgatherv in every mode, the warm start)
    and the dense executor (every collective x variant x count set bitwise
    equal to ``execute_numpy``) included."""
    chip_smoke = _chip_smoke()
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
    assert len(res["planted"]) == 2        # both planted faults refused
    for errs in res["planted"].values():
        assert all(e > chip_smoke.TOL[d] for d, e in errs.items())
    res.update(chip_smoke.partitioned_run(res, coarse_max_iters=4,
                                          dense_n=4096))
    part = res["partitioned"]
    assert part["max_rel_dev"] <= chip_smoke.HIST_RTOL
    assert all(n == 0 for n in part["launches"].values())   # no card
    assert set(part["coarse"]) == {"off", *chip_smoke.COARSE_GATHERS}
    for cg in chip_smoke.COARSE_GATHERS:
        rec = part["coarse"][cg]
        assert rec["iters"] <= part["coarse"]["off"]["iters"] + 2
        assert rec["rel"] < 1e-8
    assert part["coarse"]["ring"]["chosen"] == "ring"
    assert len(res["dense"]) == 3 * 7      # count sets x (3 + 2 + 2) variants
    assert {r["counts"] for r in res["dense"]} == {"coarsest", "even",
                                                   "ragged"}


def test_chip_smoke_calibrate_phase_runs_on_cpu(tmp_path):
    """The calibrate phase's host steps at a small size: probes, the paper
    problem's measurements, the fit (saved, then gated), its round trip,
    the planted x10 fault, the flips and the solve with every ``auto``
    under the fit against the host history.  The figures stand in for a
    card's; the times are the CPU's, so only the control flow and the
    checks are rehearsed."""
    chip_smoke = _chip_smoke()
    from repro_torch import configs

    res = chip_smoke.run("cpu", rows=4096, block_cols=16, v_cycles=2)
    part = chip_smoke.partitioned_run(res, coarse_max_iters=2, dense_n=256)
    figures = dict(vmem_limit=20000, hbm_bw=chip_smoke.PEAK_BYTES_PER_S,
                   vpu_flops=chip_smoke.PEAK_FLOPS["float64"],
                   launch_s=3e-5)
    cal = chip_smoke.calibrate_phase(
        res, part, figures, tmp_path, n_per=256, n_per_fine=1024,
        serve_cfg=configs.reduced(chip_smoke.SERVE_ARCH))
    assert (tmp_path / "trace.json").is_file()
    assert (tmp_path / "fitted_params.json").is_file()
    assert cal["params"].name == "fitted-h100"
    assert cal["gof"]["rel_rmse"] <= chip_smoke.FIT_RMSE_GATE
    assert cal["oracle"]["worst_rel"] <= chip_smoke.ORACLE_RTOL
    assert cal["planted"]["worst_rel"] <= chip_smoke.ORACLE_RTOL
    n_levels = len(res["host"]["h"].levels)
    assert len(cal["flips"]) == len(cal["levels"]) == n_levels
    assert set(cal["moe"]) == {"decode", "prefill"}
    assert cal["max_rel_dev"] <= chip_smoke.HIST_RTOL
    assert np.isfinite(cal["per_round"]["per_round"])
    # impure SpMV samples are recorded but stay out of the fit
    assert cal["summary"]["samples"] > cal["summary"]["pure_samples"]
    assert all(n == 0 for n in cal["launches"].values())   # no card


def test_fit_oracle_holds_the_rates_the_probes_excite(monkeypatch):
    """At rates whose inter latency outweighs the injection cap in every
    probe, the probes do not excite the cap: any value of it gives the
    same probe times, so the round trip holds the other four rates (to
    1e-6) and prints the cap; at ``LASSEN`` the probes excite all five.
    A fit that ignores the times is refused."""
    import repro_torch.profile
    from repro_torch.core import LASSEN, MachineParams, Topology
    from repro_torch.profile import CalibrationResult

    chip_smoke = _chip_smoke()
    slow_inter = MachineParams(
        name="slow-inter", alpha_intra=9.4e-05, beta_intra=1.19e9,
        alpha_inter=4.1e-04, beta_inter=4.86e9, region_injection_bw=1.96e9)
    got = chip_smoke.check_fit_oracle(slow_inter, Topology(8, 4), 16384)
    assert got["excited"] == list(chip_smoke.RATE_FIELDS[:4])
    assert got["worst_rel"] <= chip_smoke.ORACLE_RTOL
    assert chip_smoke.check_fit_oracle(LASSEN, Topology(8, 4), 16384)[
        "excited"] == list(chip_smoke.RATE_FIELDS)

    def ignores_the_times(trace, name="fitted", ref=LASSEN):
        return CalibrationResult(ref, ref, {"converged": 1.0,
                                            "rel_rmse": 0.0}, 1)

    monkeypatch.setattr(repro_torch.profile, "fit_trace", ignores_the_times)
    with pytest.raises(SystemExit, match="fit oracle"):
        chip_smoke.check_fit_oracle(slow_inter, Topology(8, 4), 16384)


@pytest.mark.parametrize("name", ["spmv_ell_blocked",
                                  "spmv_ell_blocked_partial"])
def test_cold_copies_compute_the_same_call(name):
    """The cold-L2 copies that the device times rotate through: enough of
    them, none sharing the call's storage, each giving the call's result
    bit for bit through the wrapper and its library product (K3's copy
    rebased to its bucket range); a call larger than the L2 is its own."""
    import numpy as np

    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(7)
    P_, C, R, K, bc = 2, 6, 40, 3, 8
    t = torch.as_tensor
    cols = t(rng.integers(0, bc, (P_, C, R, K)), dtype=torch.int32)
    vals = t(rng.standard_normal((P_, C, R, K)))
    a = dict(cols=cols, vals=vals, block_cols=bc)
    if name == "spmv_ell_blocked":
        a["x"] = t(rng.standard_normal((P_, C * bc)))
    else:
        a.update(x=t(rng.standard_normal((P_, 3 * bc))),
                 y0=t(rng.standard_normal((P_, R))), bucket_lo=2,
                 bucket_hi=5, n_buckets=C)
    nbytes = chip_smoke.work(name, a)[0]
    assert chip_smoke.cold_copies(name, a, nbytes, nbytes) == [a]
    copies = chip_smoke.cold_copies(name, a, nbytes, 3 * nbytes)
    assert len(copies) == 2 * 3
    want = chip_smoke.kernel_call(name, a)
    lib = chip_smoke.library_call(name, a)().reshape(want.shape)
    for c in copies:
        assert c["cols"].data_ptr() != cols.data_ptr()
        assert c["vals"].is_contiguous()
        assert torch.equal(chip_smoke.kernel_call(name, c), want)
        assert torch.equal(
            chip_smoke.library_call(name, c)().reshape(want.shape), lib)
    if name == "spmv_ell_blocked_partial":
        assert copies[0]["cols"].shape == (P_, 3, R, K)


def _split_call(name, rng):
    """A bf16 prefill call at a small size: K7 causal over 96 keys at head
    dim 112; K8 over T 100 at (P, N) (64, 64), one group."""
    def bf16(*shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=torch.float32).to(torch.bfloat16)

    if name == "flash_attention_bh":
        return dict(q=bf16(4, 96, 112), k=bf16(4, 96, 112),
                    v=bf16(4, 96, 112), scale=112 ** -0.5, causal=True,
                    window=0, kv_len=96, q_offset=0)
    dt = torch.nn.functional.softplus(
        torch.as_tensor(rng.standard_normal((1, 100, 4)) - 3.0,
                        dtype=torch.float32))
    A = -torch.as_tensor(np.exp(rng.uniform(0.0, np.log(16.0), 4)),
                         dtype=torch.float32)
    return dict(x=bf16(1, 100, 4, 64), dt=dt, A=A, B=bf16(1, 100, 1, 64),
                C=bf16(1, 100, 1, 64))


@pytest.mark.parametrize("name", ["flash_attention_bh", "ssd_scan_h"])
def test_split_check_tells_the_split_from_one_rounding(name, monkeypatch):
    """``split_check`` passes the plain version (the CPU's kernel) and the
    plain version with its operands carried as bf16 hi + lo, as the
    kernel carries them, and refuses one that rounds them once to bf16,
    the control's own rounding."""
    chip_smoke = _chip_smoke()
    a = _split_call(name, np.random.default_rng(3))
    got = chip_smoke.split_check(name, a, "test")
    assert got["kernel"] == got["plain"] <= chip_smoke.SPLIT_SHARE
    assert got["control"] > 10 * chip_smoke.SPLIT_SHARE

    def rounded(operand_of):
        def call(n, b):
            return chip_smoke.serve_plain_call(n, b, operand=operand_of)
        return call

    def once(t):
        return t.to(torch.bfloat16).to(t.dtype)

    def hi_lo(t):
        return once(t) + once(t - once(t))

    monkeypatch.setattr(chip_smoke, "serve_kernel_call", rounded(hi_lo))
    assert chip_smoke.split_check(name, a, "test")["kernel"] \
        <= chip_smoke.SPLIT_SHARE
    monkeypatch.setattr(chip_smoke, "serve_kernel_call", rounded(once))
    with pytest.raises(SystemExit):
        chip_smoke.split_check(name, a, "test")


def test_call_sites_are_the_models_kernel_entry_points():
    """Every call site the chip smoke binds (its oracle, its planted faults,
    its recorder) is an attribute of the model module that holds the op it
    names, so a renamed site fails here, not silently on the card."""
    import importlib

    from repro_torch.kernels import flash_attention, moe_pack, ssd_scan

    chip_smoke = _chip_smoke()
    ops = {"gather": moe_pack.pack, "combine": moe_pack.combine_lanes,
           "flash": flash_attention.attention, "ssd": ssd_scan.ssd}
    assert set(chip_smoke.CALL_SITES) == set(ops)
    for key, (mod, attr) in chip_smoke.CALL_SITES.items():
        module = importlib.import_module(f"repro_torch.models.{mod}")
        assert getattr(module, attr) is ops[key], key


def test_chip_smoke_serve_phase_runs_on_cpu():
    """The serve phase at the reduced DeepSeek-V2-Lite config: every mode
    serves all requests, the plain-version replay of the oracle's modes and
    the ample-capacity modes agree, the replay refuses all four planted
    faults (K6's last weight, K6 reading every lane's rows from lane 0,
    K7's q_offset, K7's decode combine without its last key split), and
    every K5-K7 path call and edge case is checked."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.serve_run("cpu", reduced_config=True)
    assert set(res["modes"]) == set(chip_smoke.SERVE_MODES)
    sizes = chip_smoke.serve_sizes(False)
    for mode, rec in res["modes"].items():
        assert sorted(len(t) for t in rec["tokens"].values()) == \
            sorted(sizes["new"])
        assert rec["prefills"] >= 2 and rec["decode_steps"] > 0
    for mode in chip_smoke.ORACLE_MODES:
        # the plain version itself
        assert res["modes"][mode]["oracle_rel_err"] == 0.0
    assert res["modes"]["auto"]["decode_mode"] in ("a2a", "hier",
                                                  "hier_dedup")
    planted = res["modes"][chip_smoke.ORACLE_MODES[0]]["planted"]
    assert len(planted) == 4
    assert "K6 reads every lane's rows from lane 0" in planted
    for got in planted.values():
        assert got["rel_err"] > chip_smoke.LOGIT_TOL or got["differ"] > 0
    assert set(res["kernels"]) == set(chip_smoke.SERVE_SOURCES)
    for rec in res["kernels"].values():
        assert rec["max_abs_err"] == 0.0 and rec["checked"] > 0
        assert rec["bound_ms"] > 0.0 and "decode" in rec
    assert all(n == 0 for n in res["launches"].values())   # no card
    assert all(n == 0 for n in res["cuda_launches"].values())


def test_chip_smoke_hybrid_phase_runs_on_cpu():
    """The hybrid phase at the reduced zamba2-7b config: all requests
    served, the float32 replay through the plain versions agrees, both
    planted K8 faults are refused, and every K7 / K8 path call and edge
    case is checked."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.hybrid_run("cpu", reduced_config=True)
    summ = res["summary"]
    sizes = chip_smoke.serve_sizes(False)
    assert sorted(len(t) for t in summ["tokens"].values()) == \
        sorted(sizes["new"])
    assert summ["prefills"] >= 2 and summ["decode_steps"] > 0
    assert summ["oracle_rel_err"] == 0.0          # the plain version itself
    assert summ["probe_bf16"]["kernel_vs_plain"] == 0.0
    assert len(summ["planted"]) == 2
    for got in summ["planted"].values():
        assert got["rel_err"] > chip_smoke.HYBRID_LOGIT_TOL \
            or got["differ"] > 0
    assert set(res["kernels"]) == set(chip_smoke.HYBRID_SOURCES)
    for rec in res["kernels"].values():
        assert rec["max_abs_err"] == 0.0 and rec["checked"] > 0
        assert rec["bound_ms"] > 0.0
    assert res["kernels"]["ssd_scan_h"]["library_ms"] is None
    assert "decode" in res["kernels"]["flash_attention_bh"]
    assert all(n == 0 for n in res["launches"].values())   # no card


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="with a card the script runs the A/B itself")
def test_decode_ab_refuses_to_run_without_a_card():
    """``decode_ab.py`` needs a GPU: without one it exits non-zero and
    prints no result."""
    import subprocess

    res = subprocess.run([sys.executable, str(ROOT / "decode_ab.py"), "src"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and res.stdout == ""
