"""Batched serving engine: request queue -> fixed-slot batch -> decode loop.

Ported from ``repro.serve.engine``: ``Request``, ``ServeEngine`` with
``submit``, ``step``, ``run_until_drained``, the pre-warmed decode and
worst-case prefill dispatch plans, the adaptive re-planner
(``adaptive=True``), the observe / refit loop (``observe=True``),
``verify``, the ``serve/admit``, ``serve/prefill`` and
``serve/decode_step`` spans, the ``serve/replan`` and ``serve/refit``
events, and the ``serve/request_seconds``, ``serve/steps`` and
``serve/tokens`` metrics, and elastic serving (``elastic=True``,
``resize``, ``resize_events``).

Static batch slots: requests are admitted into free slots and the whole
batch prefills together (each active slot re-presents its full history as
its prompt, right-aligned, so every slot's cache is exact after admission);
then the batch decodes one token per slot per step, and finished slots are
recycled.  Greedy sampling (argmax).

Adaptive re-planning (``adaptive=True``, moe family): every decode step
returns its measured routing histogram (``serving.decode_step(...,
return_moe_stats=True)``), which feeds a
:class:`~repro_torch.profile.adapt.AdaptivePlanner`; on a drift
re-selection the engine pins the new plan for its decode steps
(:meth:`ServeEngine._decode` reads ``moe_plan`` at every step; the
dispatch executors are cached per geometry by the plan cache, so a return
to a seen plan builds nothing).

Elastic serving (``elastic=True``): :meth:`ServeEngine.resize` drains the
decode loop mid-stream (every sequence already lives host-side as
prompt + generated), rebuilds the model on a lane mesh chosen by
``runtime.elastic.choose_mesh_shape`` for the surviving device count (or
the geometry this engine already served at that count), re-replicates the
expert weights if the physical expert count changed (else the weight
tensors stay where they are, uncopied), re-plans the decode and pinned
prefill dispatch through the SAME plan cache (a grow-back to a seen
geometry re-plans nothing) and resumes by re-prefilling the surviving
sequences, the admission contract.  Each resize is recorded as a
``runtime.controller.ResizeEvent``.

Observability (``observe=True``): the engine enables the process-wide
``repro_torch.obs`` layer with a ``TraceRecorder`` attached, and every
``refit_every`` decode steps runs ``serving.moe_exchange_probe`` (the
decode dispatch pattern as a bare exchange on the card), bridges the pure
sample into the recorder through a span and re-fits ``MachineParams``
(``profile.calibrate.fit_trace``), recorded as
:class:`~repro_torch.runtime.controller.RefitEvent`; the fitted params
price the planner's later re-selections.  Spans and refits never touch the
decode numerics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.cache import default_plan_cache
from ..models import serving
from ..models.lm import Model
from ..obs import default_obs, now
from ..profile.adapt import AdaptivePlanner, ReplanEvent

_OBS = default_obs()
_H_REQUEST = _OBS.histogram("serve/request_seconds",
                            "per-request admit->finish latency")
_C_STEPS = _OBS.counter("serve/steps", "engine steps taken")
_C_TOKENS = _OBS.counter("serve/tokens", "tokens decoded (all slots)")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [T] int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, params, batch_slots: int = 4,
                 max_len: int = 256, adaptive: bool = False,
                 drift_threshold: float = 0.3, drift_warmup: int = 2,
                 tracer=None, elastic: bool = False, observe: bool = False,
                 refit_every: int = 32):
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.elastic = elastic
        self.resize_events: List[object] = []
        # device count -> (mesh shape, axis names) this engine has served
        # on: a grow-back to a seen count reuses that exact geometry, so
        # every plan and executor for it is still in the cache
        self._seen_geometries: Dict[int, tuple] = {
            model.mesh.size: (tuple(model.mesh.shape),
                              tuple(model.mesh.axis_names)),
        }
        # online calibration (observe=True): every `refit_every` decode
        # steps, probe the dispatch exchange and refit MachineParams from
        # the tracer's pure samples; the fitted params land here and on the
        # adaptive planner
        self.observe = observe
        self.refit_every = int(refit_every)
        self.refit_events: List[object] = []
        self.machine_params = None      # last fitted MachineParams
        self._step_count = 0
        if observe:
            if tracer is None:
                from ..profile.trace import TraceRecorder

                tracer = TraceRecorder()
            # enables the process-wide obs layer and attaches the tracer as
            # the span bridge's target
            _OBS.enable(tracer=tracer)
        self._tracer = tracer
        self._drift_threshold = drift_threshold
        self._drift_warmup = drift_warmup
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.queue: List[Request] = []
        self.caches = None
        self.cur_len = 0
        self._next_tok = np.zeros((batch_slots, 1), np.int32)
        self._admit_times: Dict[int, float] = {}
        # MoE dispatch planning is hoisted out of the decode loop: the
        # decode plan (one token per slot) is built here and every decode
        # step hits it; prefill dispatch is planned once for the worst case
        # (B * max_len tokens) and pinned, so re-prefills at every history
        # length share one plan-cache entry.  The other families dispatch
        # nothing.
        self.plan_cache = default_plan_cache()
        self.moe_plan = self.moe_prefill_plan = None
        self.planner: Optional[AdaptivePlanner] = None
        self.adaptive = adaptive and model.cfg.family == "moe"
        self._warm_plans()
        if self.adaptive:
            self.planner = self._make_planner()

    def _warm_plans(self) -> None:
        """Pre-plan the decode-step dispatch (one token per slot) and the
        worst-case prefill dispatch (B * max_len tokens) of the current
        model through the engine's plan cache."""
        self.moe_plan = self.moe_prefill_plan = None
        if self.model.cfg.family == "moe":
            self.moe_plan = serving.moe_plan_for_model(
                self.model, self.B, cache=self.plan_cache)
            self.moe_prefill_plan = serving.moe_plan_for_model(
                self.model, self.B * self.max_len, cache=self.plan_cache)

    def verify(self) -> Dict[str, int]:
        """Statically verify the engine's live MoE dispatch plans.

        Runs ``repro_torch.verify``'s geometry and token-conservation
        checks over the decode-step and worst-case prefill plans (families
        without MoE dispatch verify trivially).  Raises
        :class:`repro_torch.verify.VerifyError` with a rank / slot
        diagnostic on the first violated invariant; returns check counts.
        Independent of ``REPRO_VERIFY``: calling it is the opt-in."""
        from ..verify import verify_moe_dispatch

        counts = {"moe_plans": 0}
        for plan, n_tokens in (
            (self.moe_plan, self.B),
            (self.moe_prefill_plan, self.B * self.max_len),
        ):
            if plan is None:
                continue
            verify_moe_dispatch(
                plan, serving.moe_tokens_per_lane(self.model, n_tokens))
            counts["moe_plans"] += 1
        return counts

    def _make_planner(self) -> AdaptivePlanner:
        return AdaptivePlanner(
            cfg=self.model.cfg,
            mesh=self.model.mesh,
            tokens_per_lane=serving.moe_tokens_per_lane(self.model, self.B),
            plan=self.moe_plan,
            threshold=self._drift_threshold,
            warmup=self._drift_warmup,
            # a pinned transport stays pinned: re-plans re-fingerprint
            # under the measured histogram but keep the mode; only
            # moe_mode="auto" lets drift migrate the transport
            mode=self.model.moe_mode,
            ep_over_pods=self.model.ep_over_pods,
            cap_factor=self.model.moe_cap_factor,
            params=self.model.machine_params,
            cache=self.plan_cache,
            tracer=self._tracer,
        )

    def _prefill(self, params, inputs):
        return serving.prefill(self.model, params, inputs,
                               max_len=self.max_len,
                               moe_plan=self.moe_prefill_plan)

    def _decode(self, params, inputs, caches, cur_len):
        """One decode step.  Adaptive: the current ``moe_plan`` is pinned
        and the step returns its MoE stats too."""
        if self.adaptive:
            return serving.decode_step(self.model, params, inputs, caches,
                                       cur_len, moe_plan=self.moe_plan,
                                       return_moe_stats=True)
        return serving.decode_step(self.model, params, inputs, caches,
                                   cur_len)

    @property
    def replan_events(self) -> List[ReplanEvent]:
        return self.planner.events if self.planner is not None else []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> bool:
        """Admit queued requests into free slots and (re)prefill the batch."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return False
        while free and self.queue:
            req = self.queue.pop(0)
            self.slots[free.pop(0)] = req
            if _OBS.enabled:
                self._admit_times[req.rid] = now()
        self._prefill_slots()
        return True

    def _prefill_slots(self) -> None:
        """(Re)prefill the batch from the slots' host-side histories."""
        seqs = []
        for s in self.slots:
            if s is None:
                seqs.append(np.zeros((1,), np.int32))
            else:
                seqs.append(np.concatenate(
                    [s.prompt, np.asarray(s.generated, np.int32)]))
        T = max(len(x) for x in seqs)
        toks = np.zeros((self.B, T), np.int32)
        for i, x in enumerate(seqs):
            toks[i, T - len(x):] = x  # right-align so the last token is real
        with _OBS.span("serve/prefill", tokens=self.B * T, seq_len=T):
            logits, self.caches = self._prefill(
                self.params,
                {"tokens": torch.as_tensor(toks, device=self.model.device)})
        self.cur_len = T
        self._next_tok = torch.argmax(logits, dim=-1).to(
            torch.int32).cpu().numpy()[:, None]

    # ------------------------------------------------------------- elastic
    def resize(self, n_devices: Optional[int] = None, mesh=None,
               reason: str = "requested"):
        """Drain, rebuild on a new device set, and resume mid-decode.

        Pass the surviving ``n_devices`` (the lane mesh chosen by
        ``runtime.elastic.choose_mesh_shape``, keeping the current TP
        degree when it still divides, or the geometry this engine already
        served at that count) or an explicit ``mesh``.  The model is
        rebuilt with the old one's settings; the expert weights are
        re-replicated (``models.moe.remap_expert_params``) only if the
        physical expert count changed, else every weight tensor stays
        where it is; the decode and prefill dispatch re-plan through the
        engine's plan cache (a grow-back to a served geometry re-plans
        nothing); the adaptive planner keeps its events; active sequences
        resume by re-prefilling their host-side histories.  Returns the
        recorded ``runtime.controller.ResizeEvent``.
        """
        assert self.elastic, "construct ServeEngine(..., elastic=True)"
        from ..models.moe import (
            EXPERT_WEIGHT_KEYS,
            moe_param_specs,
            remap_expert_params,
        )
        from ..runtime.controller import cache_delta_event
        from ..runtime.elastic import (
            MeshRequirements,
            choose_mesh_shape,
            make_mesh_from_devices,
        )

        old = self.model
        old_n = old.mesh.size
        before = self.plan_cache.counters()
        t0 = now()
        with _OBS.span("serve/resize", reason=reason, old_n=old_n) as sp:
            if mesh is None:
                seen = self._seen_geometries.get(int(n_devices))
                if seen is not None:
                    # a geometry this engine already served on: reusing
                    # it keeps every cached plan and executor valid
                    shape, axes = seen
                else:
                    old_tp = old.mesh.axes.get("model", 1)
                    # divisors of a working TP degree still divide the model
                    req = MeshRequirements(model_divisors=old_tp,
                                           prefer_model=old_tp)
                    shape, axes = choose_mesh_shape(int(n_devices), req)
                mesh = make_mesh_from_devices(shape, axes)
            self._seen_geometries[mesh.size] = (tuple(mesh.shape),
                                                tuple(mesh.axis_names))
            new_model = Model(
                old.cfg, mesh=mesh, moe_mode=old.moe_mode,
                ep_over_pods=old.ep_over_pods,
                moe_cap_factor=old.moe_cap_factor,
                machine_params=old.machine_params, device=old.device,
            )
            if old.cfg.family == "moe" and new_model.e_phys != old.e_phys:
                # the lanes share the card: the remapped experts are made
                # there, and every other tensor stays as it is
                e_log = old.cfg.n_experts
                params = dict(self.params)
                blocks = dict(params["blocks"])
                blocks["moe"] = remap_expert_params(
                    blocks["moe"], e_log,
                    old.e_phys // e_log, new_model.e_phys // e_log,
                )
                params["blocks"] = blocks
                self.params = params
            self.model = new_model
            self._warm_plans()
            if self.moe_plan is not None:
                # the new EP lanes must own every physical expert row
                rows = moe_param_specs(new_model.cfg, self.moe_plan)
                for k in EXPERT_WEIGHT_KEYS:
                    held = self.params["blocks"]["moe"][k].shape[1]
                    if rows[k][-1][1] != held:
                        raise ValueError(
                            f"{k}: {held} physical experts, the EP lanes "
                            f"own {rows[k][-1][1]}")
            if self.adaptive:
                events = self.planner.events if self.planner else []
                self.planner = self._make_planner()
                self.planner.events = events
            # resume: re-prefill the surviving sequences on the new lanes
            self.caches = None
            if any(s is not None for s in self.slots):
                self._prefill_slots()
            sp.set(new_n=mesh.size)
        event = cache_delta_event(self.plan_cache, before, reason, old_n,
                                  mesh.size, now() - t0)
        self.resize_events.append(event)
        return event

    def step(self) -> List[Request]:
        """One engine step: admit if possible, then decode one token for the
        active batch.  Returns the requests completed this step."""
        finished: List[Request] = []
        self._step_count += 1
        _C_STEPS.inc()
        if any(s is None for s in self.slots) and self.queue:
            with _OBS.span("serve/admit", queued=len(self.queue)):
                self._admit()
        if self.caches is None:
            return finished
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return finished
        for i in active:
            self.slots[i].generated.append(int(self._next_tok[i, 0]))
        with _OBS.span("serve/decode_step", step=self._step_count,
                       cur_len=self.cur_len, active=len(active)):
            out = self._decode(
                self.params,
                {"tokens": torch.as_tensor(self._next_tok,
                                           device=self.model.device)},
                self.caches, self.cur_len)
            if self.adaptive:
                logits, self.caches, moe_stats = out
                self._observe_moe(moe_stats)
            else:
                logits, self.caches = out
            self.cur_len += 1
            self._next_tok = torch.argmax(logits, dim=-1).to(
                torch.int32).cpu().numpy()[:, None]
        _C_TOKENS.inc(len(active))
        for i in active:
            s = self.slots[i]
            if (len(s.generated) >= s.max_new_tokens
                    or self.cur_len >= self.max_len - 1):
                s.done = True
                finished.append(s)
                self.slots[i] = None
                t_admit = self._admit_times.pop(s.rid, None)
                if t_admit is not None:
                    _H_REQUEST.observe(now() - t_admit)
        if (self.observe and self.refit_every > 0
                and self._step_count % self.refit_every == 0):
            self._refit()
        return finished

    def _observe_moe(self, moe_stats) -> Optional[ReplanEvent]:
        """Feed one decode step's measured routing histogram to the
        adaptive planner; on a drift re-selection, pin the new plan for the
        decode steps that follow."""
        event = self.planner.observe(
            moe_stats["expert_counts"].detach().to(torch.float64)
            .cpu().numpy())
        if event is not None:
            self.moe_plan = self.planner.plan
            _OBS.event("serve/replan", step=event.step,
                       drift=float(event.drift), old_mode=event.old_mode,
                       new_mode=event.new_mode)
        return event

    def _refit(self):
        """Online re-calibration: probe the live decode dispatch pattern as
        a bare exchange (no expert compute, so the sample is pure), bridge
        it into the attached tracer through a span, and re-fit
        ``MachineParams`` from every pure sample recorded so far.  Decode
        numerics are untouched: the probe runs on throwaway data and only
        ``machine_params`` and the planner's cost model change.  Returns the
        :class:`~repro_torch.runtime.controller.RefitEvent`, or ``None``
        when there is no dispatch to probe or the fit did not converge."""
        if self.moe_plan is None or self._tracer is None:
            return None
        from ..profile.calibrate import fit_trace
        from ..runtime.controller import RefitEvent

        with _OBS.span("serve/refit", step=self._step_count) as sp:
            probed = serving.moe_exchange_probe(
                self.model, self.moe_plan, self.B, cache=self.plan_cache)
            if probed is not None:
                plan, secs = probed
                # closing this span bridges (plan, secs) into the tracer as
                # a pure-exchange sample before fit_trace reads the trace
                with _OBS.span("serve/exchange_probe") as psp:
                    psp.set(plan=plan, pure_exchange=True, seconds=secs)
            ref = self.machine_params
            if ref is None and self.planner is not None:
                ref = self.planner.params
            kw = {} if ref is None else {"ref": ref}
            try:
                res = fit_trace(self._tracer, name="online-refit", **kw)
            except ValueError:
                sp.set(fitted=False, why="no pure samples")
                return None
            if not res.converged:
                sp.set(fitted=False, why="fit did not converge")
                return None
            self.machine_params = res.params
            if self.planner is not None:
                # later drift re-selections price transports under the
                # measured rates
                self.planner.params = res.params
            event = RefitEvent(
                step=self._step_count,
                params_name=res.params.name,
                rel_rmse=float(res.gof.get("rel_rmse", float("nan"))),
                n_samples=int(res.n_samples),
            )
            self.refit_events.append(event)
            sp.set(fitted=True, params_name=event.params_name,
                   rel_rmse=event.rel_rmse, n_samples=event.n_samples)
            _OBS.event("serve/refit", step=event.step,
                       params_name=event.params_name,
                       rel_rmse=event.rel_rmse, n_samples=event.n_samples)
        return event

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if not self.queue and all(s is None for s in self.slots):
                break
        return done
