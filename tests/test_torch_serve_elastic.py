"""The port's elastic serving (``ServeEngine(elastic=True).resize``) and its
expert-weight pieces, at the reduced DeepSeek-V2-Lite.

Against ``repro``:

* ``remap_expert_params`` bit-equal to ``repro``'s (r 2 -> 1 and 1 -> 2,
  float32 and bf16), router and shared experts passed through.
* ``gather_expert_weights`` returns its input bit for bit, with a
  ``DenseSelection`` equal to ``repro``'s ``PlanCache.dense_collective``
  for the same counts and topology; two EP axes are refused, as in
  ``repro``.

``repro``'s elastic decode does not run under the installed jax (a
``ShardingTypeError`` in its GQA prefill), so the reference's own contract
(``tests/multidevice_progs/check_elastic.py``'s ``check_decode_shrink``)
is held on the port alone, in float64 with ``moe_cap_factor=8.0`` and
``auto`` under ``LASSEN``: an 8-lane engine (2 pods x 4) runs 5 steps,
``resize(4)``, 4 more; against a cold 4-lane engine of 9 steps the greedy
tokens are identical and the final logits within 1e-12 (K6 accumulates in
float32, but both engines round the same expert rows the same way, so its
accumulator adds nothing here); ``resize(8)`` back is warm.  The same with
4 experts on 8 lanes (r = 2), where the resize re-replicates the experts.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from repro.core.cache import PlanCache as RefPlanCache
from repro.core.costmodel import LASSEN as REF_LASSEN
from repro.core.plan import Topology as RefTopology
from repro.models.moe import remap_expert_params as ref_remap
from repro_torch.configs import reduced
from repro_torch.core import PlanCache, default_plan_cache
from repro_torch.core.costmodel import LASSEN
from repro_torch.models import Mesh, Model
from repro_torch.models.moe import (
    EXPERT_WEIGHT_KEYS,
    dispatch_topology,
    gather_expert_weights,
    make_moe_plan,
    moe_param_specs,
    remap_expert_params,
)
from repro_torch.serve import Request, ServeEngine

NAME = "deepseek-v2-lite-16b"
EIGHT = Mesh(("pod", "model"), (2, 4))
FOUR = Mesh(("data", "model"), (1, 4))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(n_experts=None, dtype=torch.float64):
    kw = dict(dtype=dtype)
    if n_experts:
        kw["n_experts"] = n_experts
    return dataclasses.replace(reduced(NAME), **kw)


def model_for(cfg, mesh, mode="auto"):
    return Model(cfg, mesh=mesh, moe_mode=mode, machine_params=LASSEN,
                 moe_cap_factor=8.0, device="cpu")


# ------------------------------------------------------------ expert weights
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r_old,r_new", [(2, 1), (1, 2), (2, 4)])
def test_remap_expert_params_bit_equal(dtype, r_old, r_new):
    cfg = config(4, dtype)
    e_phys = cfg.n_experts * r_old
    m = model_for(cfg, Mesh(("data", "model"), (1, 1)), "a2a")
    moe = m.init_params(seed=0)["blocks"]["moe"]
    moe = {k: (v[:, :1].repeat_interleave(e_phys, 1)
               + torch.arange(e_phys, dtype=v.dtype)[None, :, None, None]
               if k in EXPERT_WEIGHT_KEYS else v) for k, v in moe.items()}
    got = remap_expert_params(moe, cfg.n_experts, r_old, r_new)
    as_ref = {k: (jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                  if v.dtype == torch.bfloat16 else v.numpy())
              for k, v in moe.items()}
    want = ref_remap(as_ref, cfg.n_experts, r_old, r_new)
    for k in moe:
        g = got[k]
        w = np.asarray(want[k])
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(np.int16)
        np.testing.assert_array_equal(g.numpy(), w)
        if k not in EXPERT_WEIGHT_KEYS:
            assert got[k] is moe[k]
    assert got["w_gate"].shape[1] == cfg.n_experts * r_new


@pytest.mark.parametrize("method", ["auto", "ring"])
def test_gather_expert_weights_bit_equal_and_selection(method):
    cfg = config(dtype=torch.float32)
    m = model_for(cfg, FOUR, "a2a")
    moe = m.init_params(seed=1)["blocks"]["moe"]
    plan = make_moe_plan(cfg, FOUR, 8, mode="a2a")
    cache = PlanCache()
    got, sel = gather_expert_weights(moe, plan, FOUR, method=method,
                                     cache=cache, params=LASSEN)
    for k in moe:
        assert torch.equal(got[k], moe[k]), k
    chunk = sum(moe[k].numel() // plan.ep_size for k in EXPERT_WEIGHT_KEYS)
    topo = dispatch_topology(plan)
    _, ref_sel = RefPlanCache().dense_collective(
        "allgatherv", np.full(plan.ep_size, chunk, dtype=np.int64),
        RefTopology(topo.n_procs, topo.procs_per_region), variant=method,
        params=REF_LASSEN)
    assert (sel.collective, sel.chosen) == (ref_sel.collective,
                                            ref_sel.chosen)
    assert sel.modeled_times == ref_sel.modeled_times
    rows = moe_param_specs(cfg, plan)
    assert rows["w_up"] == ((0, 2), (2, 4), (4, 6), (6, 8))
    assert rows["router"] is None and rows["ws_gate"] is None
    # a second gather re-plans nothing
    misses = cache.misses
    gather_expert_weights(moe, plan, FOUR, method=method, cache=cache,
                          params=LASSEN)
    assert cache.misses == misses


def test_gather_expert_weights_needs_one_ep_axis():
    cfg = config(dtype=torch.float32)
    moe = model_for(cfg, EIGHT, "a2a").init_params(seed=1)["blocks"]["moe"]
    plan = make_moe_plan(cfg, EIGHT, 8, mode="a2a")
    with pytest.raises(ValueError, match="single EP mesh axis"):
        gather_expert_weights(moe, plan, EIGHT)


# --------------------------------------------------------- elastic serving
def prompts(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab, size=(6,)).astype(np.int32)
            for _ in range(2)]


def engine(model, params, cfg, elastic=True, **kw):
    eng = ServeEngine(model, params, batch_slots=2, max_len=64,
                      elastic=elastic, **kw)
    for rid, p in enumerate(prompts(cfg)):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
    return eng


def last_logits(eng) -> torch.Tensor:
    caches = tuple({k: v.clone() for k, v in c.items()} for c in eng.caches)
    return eng._decode(eng.params,
                       {"tokens": torch.as_tensor(eng._next_tok)},
                       caches, eng.cur_len)[0]


def shrink_and_compare(cfg, params8, params4):
    """``check_decode_shrink``: 5 steps on 8 lanes, resize(4), 4 steps,
    against a cold 4-lane engine of 9 steps; then a warm grow-back."""
    eng = engine(model_for(cfg, EIGHT), params8, cfg)
    for _ in range(5):
        eng.step()
    ev = eng.resize(4, reason="heartbeat")
    assert (ev.old_n, ev.new_n, ev.reason) == (8, 4, "heartbeat")
    assert eng.model.mesh == FOUR
    for _ in range(4):
        eng.step()
    toks = [list(s.generated) for s in eng.slots]
    cold = engine(model_for(cfg, FOUR), params4, cfg, elastic=False)
    for _ in range(9):
        cold.step()
    assert toks == [list(s.generated) for s in cold.slots]
    got, want = last_logits(eng), last_logits(cold)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-12, err
    grow = eng.resize(8, reason="requested")
    assert grow.warm and grow.plan_misses == 0 and grow.exec_misses == 0
    assert grow.plan_hits > 0 and eng.model.mesh == EIGHT
    for _ in range(2):
        eng.step()
    assert eng.resize_events == [ev, grow]
    return eng, ev


def test_resize_matches_a_cold_engine_and_moves_no_weight():
    cfg = config()
    params = model_for(cfg, EIGHT).init_params(seed=0)
    default_plan_cache().clear()     # the engines plan through this cache
    eng, shrink = shrink_and_compare(cfg, params, params)
    assert not shrink.warm and shrink.plan_misses == 2   # decode, prefill
    # e_phys is 8 on both geometries: every tensor stayed where it was
    flat = [(k, v) for k, v in params["blocks"]["moe"].items()]
    for k, v in flat:
        assert eng.params["blocks"]["moe"][k] is v, k
    assert eng.params["embed"] is params["embed"]


def test_resize_rereplicates_experts_when_e_phys_changes():
    cfg = config(4)
    m4, m8 = model_for(cfg, FOUR), model_for(cfg, EIGHT)
    assert (m4.e_phys, m8.e_phys) == (4, 8)
    params4 = m4.init_params(seed=0)
    params8 = dict(params4, blocks=dict(
        params4["blocks"], moe=remap_expert_params(
            params4["blocks"]["moe"], 4, 1, 2)))
    eng = engine(m8, params8, cfg)
    for _ in range(5):
        eng.step()
    eng.resize(4, reason="heartbeat")
    for k in EXPERT_WEIGHT_KEYS:
        assert torch.equal(eng.params["blocks"]["moe"][k],
                           params4["blocks"]["moe"][k])
    assert eng.params["blocks"]["moe"]["router"] is \
        params4["blocks"]["moe"]["router"]
    shrink_and_compare(cfg, params8, params4)


def test_resize_to_an_explicit_mesh_and_new_geometries():
    cfg = config()
    params = model_for(cfg, EIGHT).init_params(seed=0)
    eng = engine(model_for(cfg, EIGHT), params, cfg)
    eng.step()
    ev = eng.resize(mesh=Mesh(("data", "model"), (2, 2)))
    assert (ev.old_n, ev.new_n) == (8, 4)
    assert eng.model.mesh.axes == {"data": 2, "model": 2}
    eng.step()
    # a count never served keeps the TP degree, 2
    eng.resize(2)
    assert eng.model.mesh == Mesh(("data", "model"), (1, 2))
    # a count served before reuses its geometry: 4 is (2, 2) again
    eng.resize(4)
    assert eng.model.mesh.axes == {"data": 2, "model": 2}
    eng.step()
    assert len(eng.resize_events) == 3
    with pytest.raises(AssertionError, match="elastic=True"):
        engine(model_for(cfg, EIGHT), params, cfg, elastic=False).resize(4)


def test_resize_keeps_the_adaptive_planners_events():
    cfg = config(dtype=torch.float32)
    params = model_for(cfg, EIGHT).init_params(seed=0)
    eng = engine(model_for(cfg, EIGHT), params, cfg, adaptive=True)
    eng.step()
    sentinel = object()
    eng.planner.events.append(sentinel)
    events = eng.planner.events
    eng.resize(4)
    assert eng.planner.events is events and events[-1] is sentinel
    assert eng.planner.mesh == FOUR
    eng.step()


def test_planted_fault_dropped_token_is_refused():
    """Resuming with a slot's last generated token dropped from its
    history must fail the comparison with the cold engine."""
    cfg = config()
    params = model_for(cfg, EIGHT).init_params(seed=0)
    eng = engine(model_for(cfg, EIGHT), params, cfg)
    for _ in range(5):
        eng.step()
    eng.slots = copy.deepcopy(eng.slots)
    eng.slots[0].generated.pop()
    eng.resize(4, reason="heartbeat")
    for _ in range(4):
        eng.step()
    cold = engine(model_for(cfg, FOUR), params, cfg, elastic=False)
    for _ in range(9):
        cold.step()
    same_tokens = ([list(s.generated) for s in eng.slots]
                   == [list(s.generated) for s in cold.slots])
    got, want = last_logits(eng), last_logits(cold)
    err = float((got - want).abs().max() / want.abs().max())
    assert not same_tokens and err > 1e-3


@pytest.mark.parametrize("cap_factor", [8.0, 64 / 6])
def test_lane_count_changes_the_prefill_only_where_pairs_drop(
        cap_factor, monkeypatch):
    """DeepSeek-V2-Lite's expert count and top-k (64, 6), float64: four
    right-aligned prompts prefilled on 8 lanes (2 pods x 4) and on 4.  The
    left pads of the shortest prompt are one token repeated, so they pick
    the same experts; at ``cap_factor`` 8 (6 x 8 / 64 slots a token, under
    one) the 8 lanes, with half the tokens a lane, overflow an expert and
    drop pairs that the 4 lanes keep, and the logits differ.  At 64 / 6 no
    pair can drop and the two lane counts give the same logits."""
    from repro_torch.models import lm, serving

    cfg = dataclasses.replace(config(64), top_k=6)
    dropped = []

    def recorded(*args, **kw):
        out = real(*args, **kw)
        dropped.append(float(out[2]))
        return out

    real = lm.moe_layer
    monkeypatch.setattr(lm, "moe_layer", recorded)
    rng = np.random.default_rng(2)
    toks = torch.zeros((4, 100), dtype=torch.int32)
    for i, n in enumerate((25, 100, 60, 80)):
        toks[i, 100 - n:] = torch.as_tensor(rng.integers(0, cfg.vocab, n))
    params = model_for(cfg, EIGHT).init_params(seed=0)
    logits, drops = {}, {}
    for name, mesh in (("8", EIGHT), ("4", FOUR)):
        m = Model(cfg, mesh=mesh, moe_mode="a2a", machine_params=LASSEN,
                  moe_cap_factor=cap_factor, device="cpu")
        dropped.clear()
        logits[name], _ = serving.prefill(m, params, {"tokens": toks},
                                          max_len=128)
        drops[name] = max(dropped)
    err = float((logits["4"] - logits["8"]).abs().max()
                / logits["8"].abs().max())
    if cap_factor < cfg.n_experts / cfg.top_k:
        assert drops["8"] > drops["4"] and err > 1e-3, (drops, err)
    else:
        assert drops == {"8": 0.0, "4": 0.0} and err < 1e-12, (drops, err)
