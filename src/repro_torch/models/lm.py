"""Model assembly for the ``dense`` and ``vlm`` families (GQA transformer
blocks), the ``moe`` family with MLA attention (DeepSeek-V2), the ``ssm``
family (Mamba-2) and the ``hybrid`` family (Zamba2).

Ported from ``repro.models.lm``: ``Model`` with its per-layer window
schedule ``windows`` (gemma3's 5 local : 1 global), ``init_params``,
``_positions`` (M-RoPE's ``[B, 3, T]`` for vlm), ``_embed_in`` (token ids,
or precomputed ``embeds`` for the vlm frontend stub), ``_logits`` and
``forward`` -> the dense block loop / ``_forward_moe`` / the SSM layer loop
/ ``_forward_hybrid`` (with ``_shared_attn_block``), and for training
``forward(return_hidden=True)``, the chunked cross entropy ``_xent`` and
``loss`` (the dense and vlm families, whose one kernel, K7, has a
backward).  The audio family and
the moe family with GQA attention are still to port (ROADMAP Queue 1) and
raise ``NotImplementedError``.

The forward runs eagerly, layer by layer, on one device: attention, norms,
projections and SSM blocks on the whole batch, the MoE layers on the mesh's
devices stacked as lanes (:mod:`repro_torch.models.moe`).  With ``remat``
(the default, as in ``repro``) and a gradient wanted, each dense layer runs
under ``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward, which is where ``jax.checkpoint`` recomputes
them, so K7's forward runs twice a layer in a training step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core.cache import default_plan_cache
from ..core.costmodel import MachineParams
from . import attention
from .attention import (
    gqa_project_out,
    gqa_project_qkv,
    init_gqa,
    init_mla,
    mla_attention,
)
from .blocks import dense_block, init_dense_block, init_mlp, mlp
from .common import ArchConfig, Initializer, Mesh, rms_norm
from .moe import MoEPlan, init_moe, make_moe_plan, moe_layer, moe_plan_for
from .ssm import init_mamba, mamba_block


def _stack_slice(tree: Dict, i: int) -> Dict:
    return {k: _stack_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def shared_expert_params(moe_params: Dict) -> Dict:
    """The shared experts' ``ws_*`` weights under ``mlp``'s names."""
    return {"w_" + k[3:]: v for k, v in moe_params.items()
            if k.startswith("ws_")}


class Model:
    """``repro``'s ``Model`` for the ``dense``, ``vlm``, ``ssm`` and
    ``hybrid`` families and the ``moe`` family with MLA.

    ``mesh`` (default: one lane) gives the MoE dispatch geometry; its
    devices are lanes stacked on ``device``.  ``machine_params`` is the
    cost model ``moe_mode="auto"`` selects under (required for ``auto`` in
    the moe family; the other families dispatch nothing)."""

    def __init__(
        self,
        cfg: ArchConfig,
        mesh: Optional[Mesh] = None,
        moe_mode: str = "auto",
        ep_over_pods: bool = True,
        moe_cap_factor: float = 1.25,
        machine_params: Optional[MachineParams] = None,
        device=None,
        remat: bool = True,
    ):
        moe = cfg.family == "moe"
        if cfg.family == "audio":
            raise NotImplementedError(
                f"{cfg.name}: the audio family (encoder-decoder with "
                "cross-attention) is not ported yet (ROADMAP Queue 1)")
        if moe and not cfg.mla:
            raise NotImplementedError(
                f"{cfg.name}: the moe family without MLA (GQA with MoE, "
                "mixtral) is not ported yet (ROADMAP Queue 1)")
        if cfg.family in ("dense", "vlm") and cfg.mla:
            raise NotImplementedError(
                f"{cfg.name}: MLA outside the moe family is not ported")
        if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
            raise ValueError(cfg.family)
        if moe and moe_mode == "auto" and machine_params is None:
            raise ValueError("moe_mode='auto' needs machine_params")
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else Mesh()
        self.moe_mode = moe_mode
        self.ep_over_pods = ep_over_pods
        self.moe_cap_factor = moe_cap_factor
        self.machine_params = machine_params
        self.remat = remat
        self.device = resolve_device(device)
        self.batch_axes = tuple(a for a in ("pod", "data")
                                if a in self.mesh.axes)
        self.e_phys = self._probe_plan().e_phys if moe else 0
        # per-layer window: with a local_global_period (gemma3) every
        # period-th layer is global (0), the others at cfg.window
        self.windows = [
            0 if cfg.local_global_period and cfg.layer_is_global(i)
            else cfg.window for i in range(cfg.n_layers)]

    def _probe_plan(self, tokens_per_lane: int = 8) -> MoEPlan:
        """Geometry-only plan (e_phys does not depend on the transport, so
        ``auto`` probes with the flat-a2a geometry)."""
        return make_moe_plan(
            self.cfg, self.mesh, tokens_per_lane,
            mode=("a2a" if self.moe_mode == "auto" else self.moe_mode),
            ep_over_pods=self.ep_over_pods,
        )

    # ------------------------------------------------------------------ init

    def init_params(self, seed: int = 0) -> Dict:
        """Weights drawn on the model's device from a seeded generator."""
        cfg = self.cfg
        init = Initializer(seed, cfg.dtype, self.device)
        p: Dict[str, Any] = {
            "embed": init.tensor((cfg.vocab, cfg.d_model), fan_in=cfg.d_model),
            "final_norm": init.tensor((cfg.d_model,), zero=True),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = init.tensor((cfg.d_model, cfg.vocab),
                                       fan_in=cfg.d_model)
        if cfg.family in ("dense", "vlm"):
            p["blocks"] = init_dense_block(init, cfg, cfg.n_layers)
            return p
        if cfg.family == "ssm":
            p["blocks"] = init_mamba(init, cfg, cfg.n_layers)
            return p
        if cfg.family == "hybrid":
            per = cfg.shared_attn_period
            n_main = cfg.n_layers // per * per
            nsb, d = cfg.n_shared_attn_blocks, cfg.d_model
            p["mamba_main"] = init_mamba(init, cfg, n_main)
            p["mamba_tail"] = (init_mamba(init, cfg, cfg.n_layers - n_main)
                               if cfg.n_layers > n_main else {})
            p["shared"] = {
                "ln1": init.tensor((nsb, 2 * d), zero=True),
                "attn": init_gqa(init, cfg, nsb, d_in=2 * d),
                "ln2": init.tensor((nsb, d), zero=True),
                "mlp": init_mlp(init, d, cfg.d_ff, nsb),
            }
            return p
        L = cfg.n_layers - cfg.first_dense_layers
        p["blocks"] = {
            "ln1": init.tensor((L, cfg.d_model), zero=True),
            "ln2": init.tensor((L, cfg.d_model), zero=True),
            "attn": init_mla(init, cfg, L),
            "moe": init_moe(init, cfg, L, self.e_phys),
        }
        if cfg.first_dense_layers:
            n0 = cfg.first_dense_layers
            p["dense0"] = {
                "ln1": init.tensor((n0, cfg.d_model), zero=True),
                "ln2": init.tensor((n0, cfg.d_model), zero=True),
                "attn": init_mla(init, cfg, n0),
                "mlp": init_mlp(init, cfg.d_model, cfg.d_ff, n0,
                                gated=cfg.gated_mlp),
            }
        return p

    # -------------------------------------------------------------- forward

    def _positions(self, inputs: Dict, T: int, B: int) -> torch.Tensor:
        """``inputs["positions"]``, else 0..T-1 for each row ([B, T]; under
        M-RoPE the same in all three rows, [B, 3, T])."""
        if "positions" in inputs:
            return inputs["positions"]
        pos = torch.arange(T, dtype=torch.int32, device=self.device)
        if self.cfg.mrope_sections is not None:
            return pos.expand(B, 3, T)
        return pos.expand(B, T)

    def _embed_in(self, params: Dict, inputs: Dict) -> torch.Tensor:
        """Precomputed ``embeds`` (the vlm frontend stub) as they are, else
        the token embeddings scaled by sqrt(d_model)."""
        if "embeds" in inputs:
            return inputs["embeds"].to(self.cfg.dtype)
        x = params["embed"][inputs["tokens"].long()]
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                device=x.device)

    def _logits(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return x @ head.to(x.dtype)

    def dense_layer(self, p_l: Dict, x: torch.Tensor, pos: torch.Tensor,
                    cache=None, kv_len=None):
        """One leading dense layer (MLA + gated MLP): (x, new cache)."""
        a, c = mla_attention(p_l["attn"], rms_norm(x, p_l["ln1"]), pos,
                             self.cfg, cache=cache, kv_len=kv_len)
        x = x + a
        return x + mlp(p_l["mlp"], rms_norm(x, p_l["ln2"]), self.cfg.act), c

    def moe_block(self, p_l: Dict, x: torch.Tensor, pos: torch.Tensor,
                  plan: MoEPlan, cache=None, kv_len=None,
                  collect: bool = False):
        """One MLA + MoE layer (routed experts dispatched by ``plan``, plus
        the shared experts): (x, new cache, router aux loss); with
        ``collect=True`` also the layer's (expert_counts [e_log] f32,
        dropped fraction), the adaptive re-planner's observation."""
        cfg = self.cfg
        a, c = mla_attention(p_l["attn"], rms_norm(x, p_l["ln1"]), pos, cfg,
                             cache=cache, kv_len=kv_len)
        x = x + a
        h = rms_norm(x, p_l["ln2"])
        out = moe_layer(h, p_l["moe"], plan, cfg, self.mesh, self.batch_axes,
                        cache=default_plan_cache(),
                        return_expert_counts=collect)
        y, aux = out[0], out[1]
        if cfg.n_shared_experts:
            y = y + mlp(shared_expert_params(p_l["moe"]), h, cfg.act)
        if collect:
            return x + y, c, aux, (out[3], out[2])
        return x + y, c, aux

    def _maybe_remat(self, fn, x: torch.Tensor, *args):
        """``fn(x, *args)``, under a checkpoint when remat is on and a
        gradient is wanted (x requires one)."""
        if self.remat and torch.is_grad_enabled() and x.requires_grad:
            return checkpoint(fn, x, *args, use_reentrant=False)
        return fn(x, *args)

    def forward(self, params: Dict, inputs: Dict,
                return_hidden: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``inputs``: {"tokens": [B, S]} or {"embeds": [B, S, d]} (and
        optionally "positions").  Returns (logits [B, S, V], aux loss);
        ``return_hidden=True`` returns the final-norm hidden states instead
        of the logits (the chunked cross entropy projects them block by
        block)."""
        x = self._embed_in(params, inputs)
        B, T = x.shape[:2]
        pos = self._positions(inputs, T, B)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.cfg.family in ("dense", "vlm"):
            for i, w in enumerate(self.windows):
                x = self._maybe_remat(self._dense_layer, x,
                                      params["blocks"], i, pos, w)
        elif self.cfg.family == "moe":
            x, aux = self._forward_moe(params, x, pos)
        elif self.cfg.family == "ssm":
            for i in range(self.cfg.n_layers):
                x, _ = mamba_block(_stack_slice(params["blocks"], i), x,
                                   self.cfg)
        else:
            x = self._forward_hybrid(params, x, pos)
        h = rms_norm(x, params["final_norm"])
        if return_hidden:
            return h, aux
        return self._logits(params, h), aux

    def _dense_layer(self, x: torch.Tensor, blocks: Dict, i: int,
                     pos: torch.Tensor, window: int) -> torch.Tensor:
        return dense_block(_stack_slice(blocks, i), x, pos, self.cfg,
                           window=window)[0]

    # ----------------------------------------------------------------- loss

    @staticmethod
    def _xent_block(xc: torch.Tensor, head: torch.Tensor, lc: torch.Tensor,
                    mc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sequence block's (ce sum, z sum) over [B, blk] positions.
        A label outside [0, V) picks no logit (ll = 0), as ``repro``'s
        one-hot sum does."""
        logits = xc @ head.to(xc.dtype)                  # [B, blk, V]
        m = torch.amax(logits, dim=-1, keepdim=True).detach().to(
            torch.float32)
        lf = logits.to(torch.float32)
        lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
        V = lf.shape[-1]
        lab = lc.long()
        ll = torch.gather(lf, -1, lab.clamp(0, V - 1)[..., None])[..., 0]
        ll = torch.where((lab >= 0) & (lab < V), ll, torch.zeros_like(ll))
        return torch.sum((lse - ll) * mc), torch.sum(torch.square(lse) * mc)

    def _xent(self, x: torch.Tensor, head: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor,
              block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sequence-chunked softmax cross entropy, ``repro``'s ``_xent``:
        the logits are made one block of ``block`` positions at a time
        (the whole sequence when ``S % block`` or ``S <= block``), each
        block checkpointed, so neither the [B, S, V] logits nor their
        float32 backward are ever held whole; the max under
        ``stop_gradient``.  Returns (ce_sum, z_sum), float32 scalars."""
        S = x.shape[1]
        if S % block or S <= block:
            block = S
        ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, S, block):
            args = (x[:, lo:lo + block], head, labels[:, lo:lo + block],
                    mask[:, lo:lo + block])
            if torch.is_grad_enabled() and x.requires_grad:
                ce, z = checkpoint(self._xent_block, *args,
                                   use_reentrant=False)
            else:
                ce, z = self._xent_block(*args)
            ce_sum = ce_sum + ce
            z_sum = z_sum + z
        return ce_sum, z_sum

    def loss(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """``ce + 1e-4 z / denom + aux`` over the positions of
        ``batch["loss_mask"]`` (all by default), with the tied head
        ``embed.T`` under ``tie_embeddings``; (total, {"ce", "aux",
        "zloss"}).  The dense and vlm families only: the MoE and SSM
        kernels (K5, K6, K8) have no backward yet (ROADMAP Queue 1)."""
        cfg = self.cfg
        if cfg.family not in ("dense", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: training the {cfg.family} family is not "
                "ported yet; its kernels have no backward (ROADMAP Queue 1)")
        x, aux = self.forward(params, batch, return_hidden=True)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        denom = torch.clamp(torch.sum(mask), min=1.0)
        ce_sum, z_sum = self._xent(x, head, labels, mask)
        ce = ce_sum / denom
        zloss = 1e-4 * z_sum / denom
        total = ce + zloss + aux
        return total, {"ce": ce, "aux": aux, "zloss": zloss}

    def _forward_moe(self, params: Dict, x: torch.Tensor,
                     pos: torch.Tensor):
        cfg = self.cfg
        B, T = x.shape[0], x.shape[1]
        axes = self.mesh.axes
        n_bdev = max(1, math.prod(axes[a] for a in self.batch_axes))
        plan = moe_plan_for(
            cfg, self.mesh, max(1, B * T // n_bdev // axes["model"]),
            mode=self.moe_mode, ep_over_pods=self.ep_over_pods,
            cap_factor=self.moe_cap_factor, params=self.machine_params,
        )
        for i in range(cfg.first_dense_layers):
            x, _ = self.dense_layer(_stack_slice(params["dense0"], i), x, pos)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers - cfg.first_dense_layers):
            x, _, aux_l = self.moe_block(_stack_slice(params["blocks"], i),
                                         x, pos, plan)
            aux = aux + aux_l
        return x, aux * cfg.router_aux_coef

    def shared_block(self, params: Dict, seg: int) -> Dict:
        """The shared attention block segment ``seg`` applies (the blocks
        alternate)."""
        return _stack_slice(params["shared"],
                            seg % self.cfg.n_shared_attn_blocks)

    def _shared_attn_block(self, p_s: Dict, x: torch.Tensor,
                           x0: torch.Tensor, pos: torch.Tensor):
        """zamba2's shared block: attention over concat(x, x0), then an
        MLP."""
        cfg = self.cfg
        h = rms_norm(torch.cat([x, x0], dim=-1), p_s["ln1"])
        q, k, v = gqa_project_qkv(p_s["attn"], h, pos, cfg)
        o = attention.flash(q, k, v, causal=True)
        x = x + gqa_project_out(p_s["attn"], o, cfg)
        return x + mlp(p_s["mlp"], rms_norm(x, p_s["ln2"]), cfg.act)

    def _forward_hybrid(self, params: Dict, x: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
        """(shared_attn_period Mamba-2 layers -> a shared attention block)
        segments, then the tail layers."""
        cfg = self.cfg
        per = cfg.shared_attn_period
        n_seg = cfg.n_layers // per
        x0 = x
        for seg in range(n_seg):
            for j in range(per):
                x, _ = mamba_block(
                    _stack_slice(params["mamba_main"], seg * per + j), x, cfg)
            x = self._shared_attn_block(self.shared_block(params, seg), x,
                                        x0, pos)
        for j in range(cfg.n_layers - n_seg * per):
            x, _ = mamba_block(_stack_slice(params["mamba_tail"], j), x, cfg)
        return x
