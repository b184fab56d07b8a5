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
    host hierarchy, the coarse allgatherv in every mode, the warm start),
    the dense executor (every collective x variant x count set bitwise
    equal to ``execute_numpy``) and the verify phase included."""
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
    # the verify phase: the three hierarchies, the set-up verified on
    # insertion, the stand-in kernel attributes, five planted faults
    ver = chip_smoke.verify_phase(res, res, on_card=False)
    assert set(ver["hierarchies"]) == {"flat", "blocked", "partitioned"}
    n_levels = len(res["host"]["h"].levels)
    for rec in ver["hierarchies"].values():
        assert rec["counts"]["levels"] == n_levels
        assert rec["counts"]["kernel_budgets"] == \
            rec["counts"]["partitions"] >= n_levels
    by_ns = ver["insertion"]["by_ns"]
    for ns in ("collective", "executor_audit", "dense_plan",
               "dense_executor_audit"):
        assert by_ns[ns][0] >= 1
    assert by_ns["collective"][0] == by_ns["executor_audit"][0]
    assert set(ver["planted"]) == {"moved_nonzero", "dropped_bucket",
                                   "swapped_scatter", "foreign_plan",
                                   "k7_smem"}
    assert ver["planted"]["moved_nonzero"]["rank"] == 0
    assert "bucket" in ver["planted"]["dropped_bucket"]
    assert "kernel" in ver["planted"]["k7_smem"]


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
    K7's q_offset, K7's decode combine without its last key split), every
    K5-K7 path call and edge case is checked, the adaptive engine
    re-plans once after its routers are zeroed, and the elastic engine's
    resize 8 -> 4 lanes changes no function."""
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
    # the adaptive phase: one re-plan after the zeroed router, the decode
    # steps after it equal to their plain replay, converged refits
    ada = res["adaptive"]
    assert ada["drift"] > chip_smoke.ADAPT_DRIFT_MIN
    assert ada["new_mode"] in ("a2a", "hier", "hier_dedup")
    assert ada["oracle_rel_err"] == 0.0        # the plain version itself
    assert ada["refits"] and ada["fitted"]["name"] == "online-refit"
    # the elastic part: no pair dropped, 4 lanes equal to 8 layer by layer
    # and whole, the resize equal to cold engines from the prompts and from
    # the histories (and in float32), the planted faults refused
    el = res["elastic"]
    assert el["dropped"] == 0.0 and max(el["layer_err"]) == 0.0
    assert el["lanes_rel_err"] == 0.0 and el["lanes_differ"] == 0
    assert el["lane_fault"] > chip_smoke.SERVE_TOL["bfloat16"]
    assert el["cold_split"] is None and max(el["cold_steps"]) == 0.0
    assert el["same_rel_err"] == 0.0 and el["oracle_rel_err"] == 0.0
    assert el["f32"]["tokens_equal"]
    assert max(el["f32"]["steps"]) <= chip_smoke.F32_LOGIT_TOL
    assert el["grow"]["plan_misses"] == 0 and el["grow"]["plan_hits"] > 0
    assert el["planted"] > chip_smoke.LOGIT_TOL
    from repro_torch.obs import default_obs
    assert not default_obs().enabled and default_obs().tracer is None


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


def test_chip_smoke_dense_phase_runs_on_cpu():
    """The dense phase at the reduced configs: gemma3-1b (prompts longer
    than its window of 16, so every decode step rolls the local caches) and
    qwen2-0.5b serve all requests through the engine, their replay through
    the plain K7 agrees and refuses each model's planted fault (gemma3's
    local layers at window 0; qwen2's decode reading the unfilled cache
    slots); nemotron-4-15b and qwen2-vl-2b (M-RoPE rows differing) run a
    prefill and 4 decode steps held to the plain K7; every K7 call is
    checked, gemma3's largest windowed prefill call timed."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.dense_run("cpu", reduced_config=True)
    sizes = chip_smoke.dense_sizes(False)
    assert set(res["served"]) == set(chip_smoke.DENSE_ARCHS)
    assert set(res["cut"]) == set(chip_smoke.DENSE_CUT_ARCHS)
    for arch, run in res["served"].items():
        summ = run["summary"]
        assert sorted(len(t) for t in summ["tokens"].values()) == \
            sorted(sizes["new"])
        assert summ["prefills"] >= 2 and summ["decode_steps"] > 0
        assert summ["oracle_rel_err"] == 0.0     # the plain version itself
        assert len(summ["planted"]) == 1
        for got in summ["planted"].values():
            assert got["rel_err"] > chip_smoke.LOGIT_TOL or got["differ"] > 0
        assert run["kernel"]["checked"] > 0 and "decode" in run["kernel"]
    assert "K7 at window 0 on the local layers" in \
        res["served"]["gemma3-1b"]["summary"]["planted"]
    from repro_torch import configs
    assert min(sizes["prompts"]) > configs.reduced("gemma3-1b").window
    for run in res["cut"].values():
        assert run["oracle_rel_err"] == 0.0 and run["kernel"]["checked"] > 0
        assert run["kernel"]["bound_ms"] > 0.0 and "decode" in run["kernel"]
    rec = res["kernels"]["flash_attention_bh"]
    assert rec["max_abs_err"] == 0.0 and rec["bound_ms"] > 0.0
    assert rec["window_prefill"]["bound_ms"] > 0.0
    assert set(rec["by_arch"]) == {*chip_smoke.DENSE_ARCHS,
                                   *chip_smoke.DENSE_CUT_ARCHS}
    assert res["launches"] == {"flash_attention_bh": 0}      # no card


def test_chip_smoke_train_phase_runs_on_cpu(tmp_path):
    """The train phase at the reduced ``qwen2-0.5b`` (vocab 128): the
    launcher's loss falls and its resumed run is bitwise the uninterrupted
    one (checkpoints under ``tmp_path``, removed after); the lane-step
    oracle passes and refuses the planted backward fault; a lane-step with
    labels -1 and V gives a finite loss; every DP variant
    passes its sync check and the planted sync fault is refused;
    ``check_grad_sync``'s problem within 1e-12; K7's edge calls (backward
    and float32 forward) pass; the launcher's call is timed; no
    launch off the card.  The backward's call site is the one the
    ``autograd.Function`` calls."""
    from repro_torch.kernels.flash_attention import flash_attention_bh

    chip_smoke = _chip_smoke()
    res = chip_smoke.train_run("cpu", reduced_config=True,
                               out_dir=tmp_path / "ck")
    assert not (tmp_path / "ck").exists()
    losses = res["launcher"]["losses"]
    assert losses[-1] < losses[0] - chip_smoke.TRAIN_LOSS_DROP
    oracle = res["oracle"]
    assert oracle["loss_err"] <= chip_smoke.ORACLE_LOSS_TOL
    assert oracle["grad_err"] <= chip_smoke.ORACLE_GRAD_TOL
    assert oracle["fault_err"] > chip_smoke.ORACLE_GRAD_TOL
    kernels = res["kernels"]
    assert kernels[chip_smoke.BWD]["checked"] == 1
    assert kernels[chip_smoke.BWD]["bound_ms"] > 0.0
    assert kernels[chip_smoke.BWD]["bf16"]["bound_ms"] > 0.0
    assert kernels["flash_attention_bh"]["train"]["bound_ms"] > 0.0
    assert kernels["flash_attention_bh"]["train_launcher"]["bound_ms"] > 0.0
    assert kernels[chip_smoke.BWD]["launcher"]["bound_ms"] > 0.0
    assert kernels["flash_attention_bh"]["f32_edge_max_err"] == 0.0
    assert np.isfinite(res["labels"]["loss"])
    variants = res["dp"]["variants"]
    assert set(variants) == set(chip_smoke.DP_METHODS)
    for method in chip_smoke.DP_METHODS[1:]:
        assert variants[method]["ok"] and variants[method]["norm_gap"] < 1e-5
        assert variants[method]["chosen"] in ("ring", "hier")
    assert variants["ring"]["chosen"] == "ring"
    assert variants["hier"]["chosen"] == "hier"
    assert not variants["auto"]["planted"]["ok"]
    assert res["problem"]["worst"] < 1e-12
    assert res["launches"] == {"flash_attention_bh": 0, chip_smoke.BWD: 0}
    assert chip_smoke.bwd_edge_checks(
        "cpu", torch.Generator().manual_seed(0)) == 0.0
    calls = []
    q = torch.randn(2, 8, 64, requires_grad=True)
    with chip_smoke.bound_bwd(lambda *a, **kw: calls.append(kw) or (
            torch.zeros_like(a[0]), torch.zeros_like(a[1]),
            torch.zeros_like(a[2]))):
        flash_attention_bh(q, q, q, scale=0.125, causal=True).sum().backward()
    assert calls == [dict(scale=0.125, causal=True, window=0)]


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
