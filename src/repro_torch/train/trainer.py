"""Trainer: the train step with microbatching, remat, optional
error-feedback gradient compression, and the explicit data-parallel
gradient sync.

Ported from ``repro.train.trainer``.  ``make_train_step(model, tcfg)``
returns ``train_step(state, batch) -> (state, metrics)``: the gradient of
``model.loss`` by ``torch.autograd`` (K7's backward on the card), summed
over ``microbatches`` slices in float32 and divided by their count as
``repro``'s ``fori_loop`` does, then AdamW.  The step runs eagerly; there
is no ``jit`` to hand it to.

Gradient sync (``TrainerConfig.grad_sync``), :func:`make_dp_train_step`:
``"jit"`` takes one gradient of the global-batch loss, the counterpart of
``repro``'s implicit GSPMD allreduce.  ``"auto"`` / ``"hier"`` / ``"ring"``
run the ``P`` data-parallel lanes (the mesh axis ``axis_name``) stacked on
one card: each lane takes the gradient of its batch shard and writes it,
in ``ravel_pytree``'s leaf order (dict keys sorted) and followed by its
loss, into its row of a rank-stacked ``[P, n_flat + 1]`` buffer; one
plan-based dense allreduce (:func:`make_grad_sync`, ``core.dense``,
selected by the Section-5 cost model) sums the rows, and the sum divided
by ``P`` is unraveled and handed to AdamW.  The same mean-of-shard-means
arithmetic as ``repro``'s ``shard_map`` step.

``repro``'s GSPMD helpers ``batch_specs``, ``state_specs`` and
``jit_train_step`` describe ``jax.jit`` shardings and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.cache import default_plan_cache
from ..core.costmodel import LASSEN, MachineParams
from ..core.dense import DenseSelection, dense_round_runner, even_counts
from ..core.plan import Topology
from ..obs import default_obs
from .compression import ef_compress_tree, init_residual
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state
from .tree import tree_leaves, tree_map, tree_unflatten

_OBS = default_obs()

GRAD_SYNC_METHODS = ("jit", "auto", "hier", "ring")


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    residual: Optional[Any]      # error-feedback state (None if off)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    microbatches: int = 1        # gradient accumulation
    compress_grads: bool = False
    # "jit" (one gradient of the global batch) | "auto" | "hier" | "ring"
    # (explicit plan-based dense allreduce, see make_dp_train_step)
    grad_sync: str = "jit"


def make_train_state(model, tcfg: TrainerConfig, seed: int = 0) -> TrainState:
    params = model.init_params(seed=seed)
    res = init_residual(params) if tcfg.compress_grads else None
    return TrainState(params, init_opt_state(params), res)


def value_and_grad(loss_fn: Callable, params, batch, has_aux: bool = False):
    """``jax.value_and_grad`` of ``loss_fn(params, batch)`` for a tree of
    tensors: ``(value, grads)``, value ``(loss, aux)`` with ``has_aux``;
    every leaf gets a gradient (zeros where the loss does not reach it),
    nothing is left requiring one."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        out = loss_fn(tree_unflatten(params, leaves), batch)
        loss, aux = out if has_aux else (out, None)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    if aux is not None:
        aux = tree_map(lambda t: t.detach(), aux)
    loss = loss.detach()
    return ((loss, aux) if has_aux else loss,
            tree_unflatten(params, grads))


def _batch_size(batch: Dict) -> int:
    """Rows of the batch: its tokens', its embeddings', else its first
    entry's leading dim."""
    for k in ("tokens", "embeds"):
        if k in batch:
            return batch[k].shape[0]
    return next(iter(batch.values())).shape[0]


def make_train_step(model, tcfg: TrainerConfig):
    """Returns train_step(state, batch) -> (new_state, metrics)."""

    def loss_fn(params, batch):
        return model.loss(params, batch)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        mb = tcfg.microbatches
        if mb > 1:
            B = _batch_size(batch)
            if B % mb:
                raise ValueError(f"batch of {B} rows in {mb} microbatches")
            per = B // mb
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(grads)[0].device)
            for i in range(mb):
                sl = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                (l, _), g = value_and_grad(loss_fn, state.params, sl,
                                           has_aux=True)
                grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                 grads, g)
                loss = loss + l
                del g
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss / mb
            metrics_extra = {}
        else:
            (loss, metrics_extra), grads = value_and_grad(
                loss_fn, state.params, batch, has_aux=True)

        residual = state.residual
        if tcfg.compress_grads:
            grads, residual = ef_compress_tree(grads, residual)

        new_params, new_opt, om = adamw_update(
            tcfg.opt, state.params, grads, state.opt
        )
        metrics = {"loss": loss, **om}
        if isinstance(metrics_extra, dict):
            metrics.update(metrics_extra)
        return TrainState(new_params, new_opt, residual), metrics

    return train_step


def _default_procs_per_region(n: int) -> int:
    for r in (4, 2, 1):
        if n % r == 0:
            return r
    return 1


def _axis_size(mesh, axis_name: str) -> int:
    """The size of ``axis_name`` in ``mesh``, a dict of axis sizes such as
    ``{"dp": 8}`` (the lanes are stacked on one card, so a mesh is its
    axes' sizes)."""
    if axis_name not in mesh:
        raise ValueError(f"mesh axes {dict(mesh)} have no axis "
                         f"{axis_name!r}")
    return int(mesh[axis_name])


def make_grad_sync(
    mesh,
    axis_name: str,
    n: int,
    method: str = "auto",
    procs_per_region: Optional[int] = None,
    cache=None,
    value_bytes: int = 8,
    params: MachineParams = LASSEN,
    device=None,
) -> Tuple[Callable, Any, DenseSelection]:
    """Explicit gradient-sync primitive: ``(sync, plan, selection)``.

    ``sync(flat)`` sums the rank-stacked flat vectors ``flat [P, m]``
    (``m <=`` the plan's padded capacity; row ``p`` is lane ``p``'s) over
    ``axis_name`` by a plan-based dense allreduce on ``device`` (default
    ``cuda``): each row padded to ``n_seg * cmax`` in one buffer that
    carries the runner's sentinel row, the rounds run in place there, and
    ``[P, m]`` returned, every row holding the sum.  ``method`` pins the
    variant (``"hier"`` / ``"ring"``) or lets the cost model choose
    (``"auto"``) under ``params`` (default ``LASSEN``); the plan comes
    through the shared :class:`PlanCache` ``dense_plan`` namespace, so
    repeated trainer builds re-plan nothing.
    """
    if method not in ("auto", "hier", "ring"):
        raise ValueError(
            f"grad_sync method {method!r} not in ('auto', 'hier', 'ring')"
        )
    n_dev = _axis_size(mesh, axis_name)
    ppr = (procs_per_region if procs_per_region is not None
           else _default_procs_per_region(n_dev))
    topo = Topology(n_dev, ppr)
    cache = cache if cache is not None else default_plan_cache()
    with _OBS.span("train/grad_sync_plan", method=method, n=n,
                   n_dev=n_dev) as sp:
        plan, sel = cache.dense_collective(
            "allreduce", even_counts(n, n_dev), topo, variant=method,
            value_bytes=value_bytes, params=params,
        )
        sp.set(chosen=sel.chosen)
    run = dense_round_runner(plan, device)
    n_seg, cmax = len(plan.counts), plan.cmax

    def sync(flat: torch.Tensor) -> torch.Tensor:
        P, m = flat.shape
        if P != n_dev:
            raise ValueError(f"grad_sync built for {n_dev} lanes, got {P}")
        if m > n_seg * cmax:
            raise ValueError(
                f"grad_sync built for {n_seg * cmax} values, got {m}"
            )
        buf = flat.new_zeros((P, n_seg + 1, cmax))
        buf.view(P, -1)[:, :m] = flat
        return run.padded(buf).view(P, -1)[:, :m]

    return sync, plan, sel


def make_dp_train_step(
    loss_fn: Callable,
    template_params: Any,
    tcfg: TrainerConfig,
    mesh,
    axis_name: str = "dp",
    procs_per_region: Optional[int] = None,
    cache=None,
    machine: MachineParams = LASSEN,
    device=None,
):
    """Pure data-parallel train step with selectable gradient sync.

    ``loss_fn(params, batch) -> scalar`` must be a *mean over the leading
    batch axis* (equal shard sizes), so the global loss is the mean of the
    lanes' losses and the global gradient the mean of their gradients:
    the explicit path (each lane's gradient, one plan-based dense
    allreduce of gradients + loss, divided by the lane count) then
    computes what the implicit one (``grad_sync="jit"``: one gradient of
    the global loss) does, up to the order of the sums.  ``mesh`` is a
    dict of axis sizes (``{"dp": 8}``); the lanes of ``axis_name`` run
    one after another on ``device`` (default: the template's).

    Returns ``(train_step, selection)``: ``train_step(state, batch) ->
    (state, metrics)`` with the batch's leading axis split evenly over the
    lanes, and ``selection`` the recorded :class:`DenseSelection`
    (``None`` for ``"jit"``).  A lane's gradient is freed once its row is
    written.
    """
    method = tcfg.grad_sync
    if method not in GRAD_SYNC_METHODS:
        raise ValueError(
            f"grad_sync {method!r} not in {GRAD_SYNC_METHODS}"
        )
    n_dev = _axis_size(mesh, axis_name)
    template = tree_leaves(template_params)
    device = template[0].device if device is None else device

    def finish(state, loss, grads):
        new_params, new_opt, om = adamw_update(
            tcfg.opt, state.params, grads, state.opt
        )
        return (TrainState(new_params, new_opt, state.residual),
                {"loss": loss, **om})

    if method == "jit":

        def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
            loss, grads = value_and_grad(loss_fn, state.params, batch)
            return finish(state, loss, grads)

        return train_step, None

    sizes = [t.numel() for t in template]
    n_flat = sum(sizes)
    dtype = template[0].dtype
    # one allreduce covers the gradient vector plus the loss scalar
    sync, _plan, sel = make_grad_sync(
        mesh, axis_name, n_flat + 1, method=method,
        procs_per_region=procs_per_region, cache=cache, params=machine,
        device=device,
    )

    def lane_rows(params, batch) -> torch.Tensor:
        """[P, n_flat + 1]: lane p's flat gradient of its shard, then its
        loss in the gradients' dtype."""
        B = _batch_size(batch)
        if B % n_dev:
            raise ValueError(f"batch of {B} rows over {n_dev} lanes")
        per = B // n_dev
        rows = torch.empty((n_dev, n_flat + 1), dtype=dtype, device=device)
        for p in range(n_dev):
            shard = {k: v[p * per:(p + 1) * per] for k, v in batch.items()}
            loss, grads = value_and_grad(loss_fn, params, shard)
            off = 0
            for g, n in zip(tree_leaves(grads), sizes):
                rows[p, off:off + n] = g.reshape(-1)
                off += n
            rows[p, n_flat] = loss.to(dtype)
            del grads
        return rows

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        rows = lane_rows(state.params, batch)
        summed = sync(rows)
        del rows
        avg = summed[0] / n_dev
        del summed
        grads = tree_unflatten(state.params, [
            part.reshape(t.shape) for part, t in
            zip(torch.split(avg[:n_flat], sizes), template)])
        return finish(state, avg[n_flat], grads)

    return train_step, sel
