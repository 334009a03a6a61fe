"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): top-k
routing with GShard capacity, the experts as batched products, and
arctic's parallel dense residual branch.

The reference's semantics, exactly:

- gate logits from the product in the compute type, then fp32; softmax,
  top-k (``lax.top_k`` is stable: among equal probabilities the lower
  expert comes first) and renormalisation in fp32;
- each expert takes ``cap = int(max(k, capacity_factor * k * s / e))``
  tokens per batch row; a (token, choice) pair's slot is the number of
  pairs before it, in the s-major flattened (s * k) order, that chose the
  same expert, and a pair whose slot reaches ``cap`` is dropped;
- the combine weights are rounded to the compute type before use, and
  each token's kept contributions are summed in fp32 and rounded once;
- the Switch aux loss is ``e * sum(density * mean_prob)`` over each
  token's first choice.

Port decision (dispatch): the reference dispatches and combines through
one-hot (b, s, e, cap) tensors and einsums. The port gathers each kept
pair's token into its (expert, row, slot) place of an (e, b * cap, d)
buffer by index, runs the experts as batched products, and adds each
pair's weighted output back into its token with ``index_add_``. A
dropped pair goes to a trash row past the buffer, which the experts
never read and whose output is zero, so no step waits on the host for
the number of kept pairs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.spec import ParamDef


def moe_defs(cfg) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.expert_ff(), cfg.num_experts
    if cfg.moe_shard == "ff":
        gate_lg = ("experts", None, "fsdp")
        down_lg = ("experts", "fsdp", None)
    else:
        gate_lg = ("experts", "fsdp", None)
        down_lg = ("experts", None, "fsdp")
    defs: Dict[str, Any] = {
        "router": ParamDef((d, e), ("embed", "experts")),
        "w_gate": ParamDef((e, d, f), gate_lg),
        "w_up": ParamDef((e, d, f), gate_lg),
        "w_down": ParamDef((e, f, d), down_lg),
    }
    if cfg.dense_residual_ff:
        defs["dense"] = L.mlp_defs(cfg, cfg.dense_residual_ff)
    return defs


def capacity(cfg, s: int, capacity_factor: float = 1.25) -> int:
    """Slots per expert per batch row for a sequence of ``s`` tokens."""
    k = cfg.top_k
    return int(max(k, capacity_factor * k * s / cfg.num_experts))


@dataclass
class Routing:
    probs: torch.Tensor    # (b, s, e) fp32 softmax of the gate logits
    topk_p: torch.Tensor   # (b, s, k) fp32, renormalised
    topk_i: torch.Tensor   # (b, s, k) int64 experts, best first
    slot: torch.Tensor     # (b, s, k) int64 place in the expert's buffer
    keep: torch.Tensor     # (b, s, k) bool: slot < cap
    cap: int


def route(cfg, p, x: torch.Tensor, capacity_factor: float = 1.25
          ) -> Routing:
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    gate = (x @ p.router.to(x.dtype)).float()
    probs = torch.softmax(gate, dim=-1)
    # a stable descending sort orders equal probabilities by expert, as
    # lax.top_k does (torch.topk promises nothing on ties)
    topk_p, topk_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_i = topk_p[..., :k], topk_i[..., :k]
    topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    flat = F.one_hot(topk_i.reshape(b, s * k), e)          # (b, s*k, e)
    before = torch.cumsum(flat, dim=1) - flat               # exclusive
    slot = torch.gather(before, 2, topk_i.reshape(b, s * k, 1))
    slot = slot.reshape(b, s, k)
    cap = capacity(cfg, s, capacity_factor)
    return Routing(probs=probs, topk_p=topk_p, topk_i=topk_i, slot=slot,
                   keep=slot < cap, cap=cap)


def moe(cfg, p, x: torch.Tensor, capacity_factor: float = 1.25):
    """x: (B, S, d) -> ((B, S, d), aux load-balance loss (fp32 scalar))."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    r = route(cfg, p, x, capacity_factor)
    cap, dev = r.cap, x.device
    n = e * b * cap                                  # the trash row's index
    row = torch.arange(b, device=dev).view(b, 1, 1)
    dest = (r.topk_i * b + row) * cap + r.slot
    dest = torch.where(r.keep, dest, n).reshape(-1)
    tok = torch.arange(b * s, device=dev).repeat_interleave(k)
    xf = x.reshape(b * s, d)
    xin = x.new_zeros(n + 1, d)
    xin[dest] = xf[tok]
    xin = xin[:n].view(e, b * cap, d)
    g = torch.bmm(xin, p.w_gate.to(x.dtype))
    u = torch.bmm(xin, p.w_up.to(x.dtype))
    xout = torch.bmm(L.silu(g) * u, p.w_down.to(x.dtype))
    xout = torch.cat([xout.reshape(n, d), x.new_zeros(1, d)])
    w = torch.where(r.keep, r.topk_p.to(x.dtype), 0).reshape(-1, 1)
    acc = torch.zeros(b * s, d, dtype=torch.float32, device=dev)
    acc.index_add_(0, tok, w.float() * xout[dest].float())
    out = acc.to(x.dtype).view(b, s, d)

    first = r.topk_i[..., 0].reshape(-1)          # counted without a sync
    density = torch.zeros(e, device=dev).index_add_(
        0, first, torch.ones(b * s, device=dev)) / (b * s)
    mean_prob = torch.mean(r.probs, dim=(0, 1))
    aux = e * torch.sum(density * mean_prob)

    if cfg.dense_residual_ff:
        out = out + L.mlp(p.dense, x)
    return out, aux
