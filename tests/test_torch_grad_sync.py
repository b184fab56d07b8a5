"""The port's explicit data-parallel gradient sync against ``repro``'s.

``make_grad_sync``'s plan (its rounds and fingerprint) and selection
(chosen variant and modeled times) equal ``repro``'s under ``TPU_V5E`` for
several (n, P, procs_per_region), and the port's rank-stacked ``sync``
equals the plan's ``execute_numpy`` bit for bit.  ``make_dp_train_step``
on ``repro``'s ``check_grad_sync`` problem (a 16 x 4 linear model in
float64, 32 rows over 8 lanes, ``tests/multidevice_progs/
check_dense_collectives.py``): ``ring`` / ``hier`` / ``auto`` within
1e-12 of ``"jit"`` in loss and updated parameters, the reference's own
bar, and ``"jit"`` within 1e-6 of ``repro``'s ``"jit"`` step on one
device (AdamW computes in float32 on both sides).  A lane's row is its
gradient in ``ravel_pytree``'s order followed by its loss.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh

from repro.core.costmodel import TPU_V5E
from repro.train import trainer as ref_trainer
from repro.train.optimizer import init_opt_state as ref_init_opt_state
from repro_torch.train import trainer
from repro_torch.train.optimizer import init_opt_state


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small CPU tensors, so that parallel
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,P,ppr,method", [
    (1001, 8, 4, "auto"), (1001, 8, 4, "hier"), (1001, 8, 4, "ring"),
    (65, 8, 2, "auto"), (12345, 6, 3, "auto"), (77, 4, None, "auto"),
    (494032769, 8, None, "auto"),
])
def test_make_grad_sync_matches_reference(n, P, ppr, method):
    sync, plan, sel = trainer.make_grad_sync(
        {"dp": P}, "dp", n, method=method, procs_per_region=ppr,
        params=TPU_V5E, device="cpu")
    _, ref_plan, ref_sel = ref_trainer.make_grad_sync(
        SimpleNamespace(shape={"dp": P}), "dp", n, method=method,
        procs_per_region=ppr, params=TPU_V5E)
    assert plan.fingerprint == ref_plan.fingerprint
    assert sel.chosen == ref_sel.chosen == plan.variant
    assert sel.modeled_times == ref_sel.modeled_times
    assert len(plan.rounds) == len(ref_plan.rounds)
    for a, b in zip(plan.rounds, ref_plan.rounds):
        assert a.pairs == b.pairs and a.reduce == b.reduce
        assert all(np.array_equal(x, y) for x, y in zip(a.segs, b.segs))
    if n > 100_000:
        return
    # the rank-stacked sync: every row the schedule's sum, bit for bit
    rng = np.random.default_rng(n)
    rows = rng.normal(size=(P, n))
    got = sync(torch.from_numpy(rows))
    assert got.shape == (P, n)
    padded = np.zeros((P, len(plan.counts) * plan.cmax))
    padded[:, :n] = rows
    want = plan.execute_numpy(list(padded))
    for p in range(P):
        np.testing.assert_array_equal(got[p].numpy(), want[p][:n])
    with pytest.raises(ValueError, match="built for"):
        sync(torch.zeros(P, len(plan.counts) * plan.cmax + 1,
                         dtype=torch.float64))


def grad_sync_problem():
    """``check_grad_sync``'s problem: params, loss and batch, numpy."""
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(16, 4)), "b": rng.normal(size=(4,))}
    batch = {"x": rng.normal(size=(32, 16)), "y": rng.normal(size=(32, 4))}
    return params, batch


def torch_loss(p, batch):
    y = batch["x"] @ p["w"] + p["b"]
    return torch.mean((y - batch["y"]) ** 2)


def test_dp_train_step_variants_match_jit():
    params, batch = grad_sync_problem()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    outs = {}
    for method in ("jit", "ring", "hier", "auto"):
        step, sel = trainer.make_dp_train_step(
            torch_loss, tp, trainer.TrainerConfig(grad_sync=method),
            {"dp": 8}, "dp", machine=TPU_V5E)
        assert (sel is None) == (method == "jit")
        state = trainer.TrainState(dict(tp), init_opt_state(tp), None)
        st2, m = step(state, tb)
        outs[method] = (st2.params, float(m["loss"]))
        if method in ("ring", "hier"):
            assert sel.chosen == method
    ref_p, ref_l = outs["jit"]
    for method in ("ring", "hier", "auto"):
        p, loss = outs[method]
        assert abs(loss - ref_l) < 1e-12, (method, loss - ref_l)
        for k in ref_p:
            d = float(torch.max(torch.abs(p[k] - ref_p[k])))
            assert d < 1e-12, (method, k, d)

    # "jit" against repro's "jit" step on one device
    with jax.enable_x64(True):
        def loss_fn(p, b):
            y = b["x"] @ p["w"] + p["b"]
            return jnp.mean((y - b["y"]) ** 2)

        mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
        jp = jax.tree.map(jnp.asarray, params)
        step, _ = ref_trainer.make_dp_train_step(
            loss_fn, jp, ref_trainer.TrainerConfig(grad_sync="jit"), mesh,
            "dp")
        st, m = step(ref_trainer.TrainState(jp, ref_init_opt_state(jp),
                                            None),
                     jax.tree.map(jnp.asarray, batch))
        assert abs(float(m["loss"]) - ref_l) < 1e-12
        for k in ref_p:
            np.testing.assert_allclose(ref_p[k].numpy(),
                                       np.asarray(st.params[k]), rtol=0,
                                       atol=1e-6)


def test_lane_rows_follow_ravel_pytree_order(monkeypatch):
    """Each lane's row is its gradient in ``ravel_pytree``'s order (dict
    keys sorted, at every depth) followed by its loss."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(6, 3)), "b": rng.normal(size=(3,)),
              "a": {"z": rng.normal(size=(3,)), "c": rng.normal(size=(2,))}}
    batch = {"x": rng.normal(size=(8, 6)), "y": rng.normal(size=(8, 3))}

    def tl(p, b):
        y = b["x"] @ p["w"] + p["b"] * p["a"]["z"] + p["a"]["c"].sum()
        return torch.mean((y - b["y"]) ** 2)

    def jl(p, b):
        y = b["x"] @ p["w"] + p["b"] * p["a"]["z"] + p["a"]["c"].sum()
        return jnp.mean((y - b["y"]) ** 2)

    seen = []
    real = trainer.make_grad_sync

    def recording(*args, **kw):
        sync, plan, sel = real(*args, **kw)

        def rec(flat):
            seen.append(flat.clone())
            return sync(flat)

        return rec, plan, sel

    monkeypatch.setattr(trainer, "make_grad_sync", recording)
    tp = {"w": torch.from_numpy(params["w"]),
          "b": torch.from_numpy(params["b"]),
          "a": {k: torch.from_numpy(v) for k, v in params["a"].items()}}
    step, _ = trainer.make_dp_train_step(
        tl, tp, trainer.TrainerConfig(grad_sync="ring"), {"dp": 4}, "dp",
        machine=TPU_V5E)
    step(trainer.TrainState(tp, init_opt_state(tp), None),
         {k: torch.from_numpy(v) for k, v in batch.items()})
    rows = seen[0].numpy()
    assert rows.shape == (4, 18 + 3 + 3 + 2 + 1)
    with jax.enable_x64(True):
        for p in range(4):
            shard = {k: jnp.asarray(v[2 * p:2 * p + 2])
                     for k, v in batch.items()}
            loss, g = jax.value_and_grad(jl)(
                jax.tree.map(jnp.asarray, params), shard)
            want = np.concatenate([np.asarray(ravel_pytree(g)[0]),
                                   [float(loss)]])
            np.testing.assert_allclose(rows[p], want, rtol=1e-12,
                                       atol=1e-14)
