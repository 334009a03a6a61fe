"""xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks (port
of ``repro/models/xlstm.py``).

The mLSTM runs a sequence in the chunked-parallel form (attention-like
products inside each chunk, a recurrence across chunks in log space
with a running stabiliser m) and decodes recurrently, O(1) a token. The
sLSTM mixes its hidden state through R·h_{t-1}, so it is sequential:
one product takes the input projection of the whole sequence, and a
loop runs the cheap recurrent part. Every ``cfg.slstm_every``-th block
is an sLSTM: the blocks form groups of mLSTMs followed by one sLSTM (or
one group of mLSTMs alone when there is none).

Parameters: ``XLSTM.embed``, ``.mlstm[g][m]`` (group g's m-th mLSTM),
``.slstm[g]`` (its sLSTM; None without), ``.norm_f``, each block under
the reference's keys. ``slstm/r`` and ``slstm/b`` are held in fp32, as
the reference reads them; ``mlstm/bf`` is a vector, fp32 too.

Rounding, as the reference's: the projections are products in
``cfg.dtype``; q is then scaled by 1/sqrt(hd) in fp32 (the reference's
numpy scalar promotes it); the gates and both recurrences run in fp32
(in fp64 for an fp64 input); masked log weights are -1e30, so their
``exp`` is 0 and never NaN.

Port decisions:

- ``mlstm_parallel`` computes every chunk's intra-chunk terms at once;
  the loop over chunks carries only (C, n, m): first m, a (B, H) max,
  then C and n, each chunk's update C' = e^(m + F - m') C + sum_s w_s
  k_s v_s^T with its products taken for all chunks in one batched
  product. The terms are the reference's ``lax.scan`` body's, element
  for element.
- ``slstm_scan`` on the card runs its first step, captures the step as
  a CUDA graph (``graph.capture``; the position a device tensor that
  the step advances) and replays it for the rest: a 2,048-token prompt
  is 2,048 steps of ~40 small kernels in each of six blocks. A captured
  graph records no autograd, so where gradients are taken the scan is
  ``SLSTMScan``, a ``torch.autograd.Function`` whose forward keeps each
  step's gates and states and whose backward runs the reverse
  recurrence; on the card both loops are captured graphs.
- Training reads the stacked {reference path: tensor} dict through
  ``stacked_views`` and recomputes each mLSTM block in the backward pass
  (``remat="block"``), as the reference does; the sLSTM is not
  recomputed.
- ``prefill`` and ``decode_step`` write the final states into the
  ``XLSTMState``'s tensors in place (the reference returns new ones)
  and return a state over the same tensors; on the card a state's
  decode steps are one captured CUDA graph (``graph.StepGraph``).
- ``state_spec`` gives the state's abstract tree and partition specs
  for the dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

import repro_torch
from repro_torch import counted
from repro_torch.models import graph as G
from repro_torch.models import layers as L
from repro_torch.models.spec import ParamDef, TensorSpec
from repro_torch.models.transformer import (Group, embed_view, layer_tree,
                                            stack_defs, stacked_rows,
                                            torch_dtype)
from repro_torch.sharding.partitioning import P

NEG = -1e30     # the reference's "minus infinity" for log weights


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------
def mlstm_defs(cfg) -> Dict[str, ParamDef]:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.hd()
    return {
        "norm": ParamDef((d,), ("embed",), init="ones"),
        "wq": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wv": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wi": ParamDef((d, h), ("embed", "heads")),
        "wf": ParamDef((d, h), ("embed", "heads")),
        "bf": ParamDef((h,), ("heads",), init="ones", scale=3.0),
        "wog": ParamDef((d, d), ("embed", "model")),
        "wo": ParamDef((d, d), ("model", "embed")),
    }


def slstm_defs(cfg) -> Dict[str, ParamDef]:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.hd()
    return {
        "norm": ParamDef((d,), ("embed",), init="ones"),
        "wx": ParamDef((d, 4, h, hd), ("embed", None, "heads", None)),
        "r": ParamDef((4, h, hd, hd), (None, "heads", None, None), scale=0.5,
                      read_as="float32"),
        "b": ParamDef((4, h, hd), (None, "heads", None), init="zeros",
                      read_as="float32"),
        "wo": ParamDef((d, d), ("model", "embed")),
    }


def _n_slstm(cfg) -> int:
    return cfg.num_layers // cfg.slstm_every if cfg.slstm_every else 0


def group_shape(cfg) -> Tuple[int, int]:
    """(groups, mLSTMs per group)."""
    n_s = _n_slstm(cfg)
    groups = n_s if n_s else 1
    return groups, (cfg.num_layers // groups) - (1 if n_s else 0)


def has_slstm(cfg) -> bool:
    return _n_slstm(cfg) > 0


def model_defs(cfg) -> Dict[str, Any]:
    groups, per_group_m = group_shape(cfg)
    d = {
        "embed": L.embed_defs(cfg),
        "norm_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "mlstm": stack_defs(stack_defs(mlstm_defs(cfg), per_group_m),
                            groups),
    }
    if has_slstm(cfg):
        d["slstm"] = stack_defs(slstm_defs(cfg), groups)
    return d


class XLSTM(nn.Module):
    """The parameters of one model: ``embed``, ``mlstm``, ``slstm``,
    ``norm_f``."""

    def __init__(self, cfg, flat: Dict[str, torch.Tensor]):
        """``flat``: {reference path: tensor}, ``mlstm/*`` stacked (G, M,
        ...), ``slstm/*`` (G, ...)."""
        super().__init__()
        self.cfg = cfg
        g, m = group_shape(cfg)
        self.embed = Group({"tok": flat["embed/tok"],
                            "unembed": flat["embed/unembed"]})
        self.mlstm = nn.ModuleList(
            nn.ModuleList(Group(layer_tree(flat, "mlstm", (i, j)))
                          for j in range(m)) for i in range(g))
        self.slstm = nn.ModuleList(
            Group(layer_tree(flat, "slstm", i)) for i in range(g)) \
            if has_slstm(cfg) else None
        self.norm_f = nn.Parameter(flat["norm_f"], requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def stacked_views(cfg, flat: Dict[str, torch.Tensor]) -> SimpleNamespace:
    """The training twin of ``XLSTM`` (see ``transformer.stacked_views``):
    ``mlstm[g][m]`` reads row (g, m) of each ``mlstm/*`` tensor (G, M,
    ...), ``slstm[g]`` row g of each ``slstm/*`` (G, ...; None without
    sLSTM blocks), so gradients come back in those stacked layouts."""
    g, m = group_shape(cfg)
    return SimpleNamespace(
        embed=embed_view(flat), mlstm=stacked_rows(flat, "mlstm", (g, m)),
        slstm=stacked_rows(flat, "slstm", (g,)) if has_slstm(cfg) else None,
        norm_f=flat["norm_f"])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _wide(x: torch.Tensor) -> torch.dtype:
    """The type the gates and recurrences run in: fp32, or fp64 for an
    fp64 input (the exact evaluation the card's checks hold fp32 to)."""
    return torch.promote_types(x.dtype, torch.float32)


def _qkvif(cfg, p, x: torch.Tensor):
    """q (fp32, scaled), k, v (x's type), log input and log forget gates
    (fp32), each (B, S, H[, hd])."""
    dt, wide = x.dtype, _wide(x)
    q = L.proj(x, p.wq.to(dt)).to(wide) * (1.0 / math.sqrt(cfg.hd()))
    k = L.proj(x, p.wk.to(dt))
    v = L.proj(x, p.wv.to(dt))
    logi = (x @ p.wi.to(dt)).to(wide)
    logf = L.log_sigmoid((x @ p.wf.to(dt)).to(wide) + p.bf.to(wide))
    return q, k, v, logi, logf


def _out(p, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The output gate and projection: (y * sigmoid(x Wog)) Wo, in x's
    type. y: (B, S, H * hd) fp32."""
    og = L.sigmoid(x @ p.wog.to(x.dtype))
    return (y.to(x.dtype) * og) @ p.wo.to(x.dtype)


def mlstm_zero_state(b: int, h: int, hd: int, device,
                     dtype: torch.dtype = torch.float32):
    """(C, n, m) as the reference starts them: 0, 0, -1e30 (in fp32;
    fp64 for the exact evaluation)."""
    return (torch.zeros((b, h, hd, hd), dtype=dtype, device=device),
            torch.zeros((b, h, hd), dtype=dtype, device=device),
            torch.full((b, h), NEG, dtype=dtype, device=device))


def mlstm_parallel(cfg, p, x: torch.Tensor, state=None, terms=None):
    """Chunked-parallel mLSTM over whole sequences. x: (B, S, d).
    Returns (out, (C, n, m)): C (B, H, hd, hd), n (B, H, hd), m (B, H),
    fp32. S must be a multiple of min(``cfg.mlstm_chunk``, S), as the
    reference asserts. ``terms``, a dict where given, receives the chunk
    body's intermediate terms by name (for precision probes)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.hd()
    qc = int(min(cfg.mlstm_chunk, s))
    if s % qc:
        raise ValueError(f"mlstm_parallel: {s} positions are not a "
                         f"multiple of the {qc}-position chunk")
    nc = s // qc
    q, k, v, li, lf = _qkvif(cfg, p, x)
    q = q.view(b, nc, qc, h, hd)
    k = k.to(q.dtype).view(b, nc, qc, h, hd)
    v = v.to(q.dtype).view(b, nc, qc, h, hd)
    li, lf = li.view(b, nc, qc, h), lf.view(b, nc, qc, h)
    c, n, m = state if state is not None else \
        mlstm_zero_state(b, h, hd, x.device, q.dtype)

    fcum = torch.cumsum(lf, dim=2)                        # (b, nc, t, h)
    # intra-chunk log weights A[t, s] = F_t - F_s + log i_s  (s <= t)
    a = fcum[:, :, :, None] - fcum[:, :, None] + li[:, :, None]
    causal = torch.ones((qc, qc), dtype=torch.bool, device=x.device).tril()
    a = torch.where(causal[:, :, None], a, NEG)           # (b, nc, t, s, h)
    f_total = fcum[:, :, -1]                              # (b, nc, h)
    wk_log = f_total[:, :, None] - fcum + li              # (b, nc, s, h)
    # the stabiliser entering each chunk, then its end-of-chunk updates
    (m,), seen = G.scan(
        lambda m, f_j, wk_j: (torch.maximum(m + f_j, wk_j.amax(dim=1)),),
        (m,), (f_total, wk_log))
    m_in = torch.stack([e[0] for e in seen], dim=1)       # (b, nc, h)
    m_out = torch.cat([m_in[:, 1:], m[:, None]], dim=1)
    bvec = m_in[:, :, None] + fcum                        # carry-in
    m_t = torch.maximum(bvec, a.amax(dim=3))              # (b, nc, t, h)
    w = torch.exp(a - m_t[:, :, :, None])                 # intra weights
    w_in = torch.exp(bvec - m_t)                          # carry-in weight
    qkw = torch.einsum("bcthk,bcshk->bctsh", q, k) * w
    # C and n entering each chunk
    wk_s = torch.exp(wk_log - m_out[:, :, None])          # (b, nc, s, h)
    decay = torch.exp(m_in + f_total - m_out)             # (b, nc, h)
    kv = torch.einsum("bcsh,bcshk,bcshv->bchkv", wk_s, k, v)
    ks = torch.einsum("bcsh,bcshk->bchk", wk_s, k)
    (c, n), seen = G.scan(
        lambda c, n, d_j, kv_j, ks_j: (d_j[:, :, None, None] * c + kv_j,
                                       d_j[:, :, None] * n + ks_j),
        (c, n), (decay, kv, ks))
    if terms is not None:
        terms.update(q=q, k=k, v=v, fcum=fcum, m_t=m_t, w=w, w_in=w_in,
                     qkw=qkw, kv=kv, ks=ks)
    del kv
    c_in = torch.stack([e[0] for e in seen], dim=1)
    n_in = torch.stack([e[1] for e in seen], dim=1)
    del seen
    num = (torch.einsum("bctsh,bcshk->bcthk", qkw, v)
           + w_in[..., None] * torch.einsum("bchkv,bcthk->bcthv", c_in, q))
    den = (qkw.sum(dim=3)
           + w_in * torch.einsum("bchk,bcthk->bcth", n_in, q))
    y = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    if terms is not None:
        terms.update(c_in=c_in, n_in=n_in, num=num, den=den, y=y)
    return _out(p, x, y.reshape(b, s, h * hd)), (c, n, m)


def mlstm_step(cfg, p, x: torch.Tensor, state):
    """One-token recurrent mLSTM. x: (B, 1, d); state = (C, n, m)."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.hd()
    q, k, v, li, lf = _qkvif(cfg, p, x)
    q, k, v = q[:, 0], k[:, 0].to(q.dtype), v[:, 0].to(q.dtype)
    li, lf = li[:, 0], lf[:, 0]
    c, n, m = state
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(li - m_new)
    c = fp[..., None, None] * c + ip[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", c, q)
    den = torch.einsum("bhk,bhk->bh", n, q)
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return _out(p, x, y.reshape(b, 1, h * hd)), (c, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_zero_state(b: int, h: int, hd: int, device,
                     dtype: torch.dtype = torch.float32):
    """(c, n, m, h) as the reference starts them: 0, 1e-6, -1e30, 0 (in
    fp32; fp64 for the exact evaluation)."""
    zeros = torch.zeros((b, h, hd), dtype=dtype, device=device)
    return zeros, zeros + 1e-6, zeros + NEG, zeros.clone()


def _slstm_gates(r: torch.Tensor, wx_t: torch.Tensor, hprev):
    """The step's gate pre-activations (B, 4, H, hd): wx_t (the input
    projection plus bias) + R h_{t-1}, r (H, 4 * hd, hd) heads first."""
    hh, hd = hprev.shape[1:]
    rec = torch.bmm(r, hprev.permute(1, 2, 0))            # (H, 4hd, B)
    return wx_t + rec.view(hh, 4, hd, -1).permute(3, 1, 0, 2)


def _slstm_update(g: torch.Tensor, c, n, m):
    """The step's new state (c, n, m, h) from its gates and the state
    before it."""
    zt = torch.tanh(g[:, 0])
    it = g[:, 1]
    ft = L.log_sigmoid(g[:, 2])
    ot = L.sigmoid(g[:, 3])
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(ft + m - m_new)
    c = fp * c + ip * zt
    n = fp * n + ip
    return c, n, m_new, ot * (c / torch.clamp_min(n, 1e-6))


def _slstm_cell(r: torch.Tensor, wx_t: torch.Tensor, c, n, m, hprev):
    """One sLSTM step. r: (H, 4 * hd, hd), the recurrent weights heads
    first; wx_t: (B, 4, H, hd) the input projection plus bias, fp32."""
    return _slstm_update(_slstm_gates(r, wx_t, hprev), c, n, m)


def _slstm_cell_backward(g, c, n, m, c1, n1, m1, dc, dn, dm, dh):
    """The reverse of ``_slstm_update``: from the gates g, the state
    before the step (c, n, m), the state after it (c1, n1, m1) and the
    gradients of that state (dc, dn, dm, dh), the gradients of g and of
    (c, n, m). Each line is the derivative autograd takes through the
    forward's operation: ``torch.maximum`` splits a tie's gradient in
    halves, ``clamp_min`` passes it where n1 >= 1e-6."""
    zt = torch.tanh(g[:, 0])
    it = g[:, 1]
    a = L.log_sigmoid(g[:, 2]) + m
    ot = L.sigmoid(g[:, 3])
    ip = torch.exp(it - m1)
    fp = torch.exp(a - m1)
    nc = torch.clamp_min(n1, 1e-6)
    d_ot = dh * (c1 / nc)
    dq = dh * ot
    dc = dc + dq / nc
    dn = dn + torch.where(n1 >= 1e-6, -dq * c1 / (nc * nc), 0.0)
    dfp = dc * c + dn * n
    dip = dc * zt + dn
    dit = dip * ip
    da = dfp * fp
    dm1 = dm - dit - da
    share = torch.where(a > it, 1.0, torch.where(a == it, 0.5, 0.0)).to(
        dm1.dtype)
    da = da + dm1 * share
    dit = dit + dm1 * (1 - share)
    dg = torch.stack([dc * ip * (1 - zt * zt), dit,
                      da * L.sigmoid(-g[:, 2]), d_ot * ot * (1 - ot)], dim=1)
    return dg, dc * fp, dn * fp, da


@counted
def _run_steps(step, n: int, device: torch.device, graphed: bool):
    """``step()`` n times; ``graphed``: the first runs, then the step is
    captured once as a CUDA graph (``graph.capture``) and replayed."""
    if not graphed or n < 2:
        for _ in range(n):
            step()
        return
    _, graph, _ = G.capture(step, device)
    for _ in range(n - 1):
        graph.replay()


def _scan_eager(r, wx, state):
    ys = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(r, wx[:, t], *state)
        ys.append(state[3])
    return torch.stack(ys, dim=1), state


def _scan_graphed(r, wx, state):
    """``_scan_eager`` on the card: the first step runs, then the step
    (reading its input at a device-side position and advancing it) is
    captured once and replayed for the rest of the sequence."""
    b, s = wx.shape[:2]
    st = tuple(t.clone() for t in state)
    ys = wx.new_empty((b, s) + tuple(st[3].shape[1:]))
    t = torch.zeros(1, dtype=torch.int64, device=wx.device)

    def step():
        new = _slstm_cell(r, wx.index_select(1, t)[:, 0], *st)
        for dst, src in zip(st, new):
            dst.copy_(src)
        ys.index_copy_(1, t, new[3][:, None])
        t.add_(1)
    _run_steps(step, s, wx.device, True)
    return ys, st


class SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence with its own backward, for training.

    ``apply(r, wx, c0, n0, m0, h0, graphed)`` -> (ys (B, S, H, hd), c, n,
    m, h): ``_scan_eager``'s values (the same operations). Forward keeps
    each step's gates (B, S, 4, H, hd) and the states before and after
    every step, (c, n, m, h) at S + 1 positions; backward runs the
    reverse recurrence (``_slstm_cell_backward``, then R^T dg into the
    previous h) from the last step to the first, and takes R's gradient
    as one product of all steps' gate gradients with the h before each.
    It returns the gradients of r, wx and the initial state.

    ``graphed`` (on the card): the forward step and the reverse step each
    read and write their position through a device tensor, so each is
    captured once as a CUDA graph and replayed (512 steps of ~40 kernels,
    forward and backward, in each of xlstm-1.3b's six sLSTM blocks);
    otherwise both loops run step by step, the same operations."""

    @staticmethod
    def forward(ctx, r, wx, c0, n0, m0, h0, graphed: bool):
        b, s = wx.shape[:2]
        seqs = []
        for t0 in (c0, n0, m0, h0):
            buf = t0.new_empty((b, s + 1) + tuple(t0.shape[1:]))
            buf[:, 0] = t0
            seqs.append(buf)
        cs, ns, ms, hs = seqs
        gs = torch.empty_like(wx)
        pos = torch.zeros(1, dtype=torch.int64, device=wx.device)

        def step():
            prev = [t.index_select(1, pos)[:, 0] for t in seqs]
            g = _slstm_gates(r, wx.index_select(1, pos)[:, 0], prev[3])
            new = _slstm_update(g, *prev[:3])
            gs.index_copy_(1, pos, g[:, None])
            nxt = pos + 1
            for buf, t in zip(seqs, new):
                buf.index_copy_(1, nxt, t[:, None])
            pos.add_(1)
        _run_steps(step, s, wx.device, graphed)
        ctx.save_for_backward(r, gs, cs, ns, ms, hs)
        ctx.graphed = graphed
        return (hs[:, 1:].contiguous(),) + tuple(t[:, s].clone()
                                                 for t in seqs)

    @staticmethod
    def backward(ctx, dys, dc, dn, dm, dh):
        r, gs, cs, ns, ms, hs = ctx.saved_tensors
        b, s, _, hh, hd = gs.shape
        dgs = torch.empty_like(gs)
        carry = [t.contiguous().clone() for t in (dc, dn, dm, dh)]
        dys = dys.contiguous()
        rt = r.transpose(1, 2).contiguous()               # (H, hd, 4hd)
        pos = torch.full((1,), s - 1, dtype=torch.int64, device=gs.device)

        def step():
            nxt = pos + 1
            g = gs.index_select(1, pos)[:, 0]
            before = [t.index_select(1, pos)[:, 0] for t in (cs, ns, ms)]
            after = [t.index_select(1, nxt)[:, 0] for t in (cs, ns, ms)]
            dh_t = carry[3] + dys.index_select(1, pos)[:, 0]
            dg, dc_, dn_, dm_ = _slstm_cell_backward(
                g, *before, *after, carry[0], carry[1], carry[2], dh_t)
            dgs.index_copy_(1, pos, dg[:, None])
            drec = dg.permute(2, 1, 3, 0).reshape(hh, 4 * hd, b)
            dh_ = torch.bmm(rt, drec).permute(2, 0, 1)    # (B, H, hd)
            for dst, src in zip(carry, (dc_, dn_, dm_, dh_)):
                dst.copy_(src)
            pos.sub_(1)
        _run_steps(step, s, gs.device, ctx.graphed)
        dr = torch.bmm(
            dgs.permute(3, 2, 4, 0, 1).reshape(hh, 4 * hd, b * s),
            hs[:, :s].permute(2, 0, 1, 3).reshape(hh, b * s, hd))
        return (dr, dgs, *carry, None)


def slstm_scan(cfg, p, x: torch.Tensor, state=None):
    """Whole-sequence sLSTM: the input product outside, the recurrence in
    a loop. Returns (out, (c, n, m, h)), the state fp32 (B, H, hd).

    Where autograd records (gradients enabled and any input requiring
    them) the recurrence is ``SLSTMScan``, graphed on the card; otherwise
    ``_scan_graphed`` on the card (s > 1) or ``_scan_eager``."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.hd()
    wx = (x @ p.wx.to(x.dtype).reshape(d, 4 * h * hd)).view(
        b, s, 4, h, hd).to(_wide(x)) + p.b.to(_wide(x))
    r = p.r.to(_wide(x)).transpose(0, 1).reshape(h, 4 * hd, hd)
    if state is None:
        state = slstm_zero_state(b, h, hd, x.device, _wide(x))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, wx, *state)):
        ys, *state = SLSTMScan.apply(r, wx, *state, repro_torch.on_card(x))
        state = tuple(state)
    else:
        scan = _scan_graphed if repro_torch.on_card(x) and s > 1 \
            else _scan_eager
        ys, state = scan(r, wx, state)
    y = ys.reshape(b, s, d).to(x.dtype)
    return y @ p.wo.to(x.dtype), state


def slstm_step(cfg, p, x: torch.Tensor, state):
    return slstm_scan(cfg, p, x, state)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------
@dataclass
class XLSTMState:
    mc: torch.Tensor    # (G, M, B, H, hd, hd) fp32
    mn: torch.Tensor    # (G, M, B, H, hd)
    mm: torch.Tensor    # (G, M, B, H)
    sc: torch.Tensor    # (G, B, H, hd)
    sn: torch.Tensor
    sm: torch.Tensor
    sh: torch.Tensor
    length: int         # tokens consumed (a host int)
    # on the card, the decode step captured for these tensors
    graph: Optional[G.StepGraph] = field(default=None, repr=False)


def init_state(cfg, batch: int, device) -> XLSTMState:
    g, m_per = group_shape(cfg)
    h, hd = cfg.num_heads, cfg.hd()
    mc, mn, mm = mlstm_zero_state(g * m_per * batch, h, hd, device)
    sc, sn, sm, sh = slstm_zero_state(g * batch, h, hd, device)
    return XLSTMState(
        mc=mc.view(g, m_per, batch, h, hd, hd),
        mn=mn.view(g, m_per, batch, h, hd), mm=mm.view(g, m_per, batch, h),
        sc=sc.view(g, batch, h, hd), sn=sn.view(g, batch, h, hd),
        sm=sm.view(g, batch, h, hd), sh=sh.view(g, batch, h, hd),
        length=0)


def state_spec(cfg, batch: int, rules):
    """(abstract state, its partition specs), each an ``XLSTMState``: the
    batch and head axes split by the rules; ``length`` the reference's
    int32 scalar (a host int here)."""
    g, m_per = group_shape(cfg)
    h, hd = cfg.num_heads, cfg.hd()
    shp = dict(mc=((g, m_per, batch, h, hd, hd),
                   (None, None, "batch", "heads", None, None)),
               mn=((g, m_per, batch, h, hd),
                   (None, None, "batch", "heads", None)),
               mm=((g, m_per, batch, h), (None, None, "batch", "heads")))
    for k in ("sc", "sn", "sm", "sh"):
        shp[k] = ((g, batch, h, hd), (None, "batch", "heads", None))
    return (XLSTMState(**{k: TensorSpec(s, torch.float32)
                          for k, (s, _) in shp.items()},
                       length=TensorSpec((), torch.int32)),
            XLSTMState(**{k: rules.spec_for(s, lg)
                          for k, (s, lg) in shp.items()}, length=P()))


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------
def _mlstm_block(cfg, bp, x: torch.Tensor) -> torch.Tensor:
    return x + mlstm_parallel(cfg, bp, L.rmsnorm(x, bp.norm))[0]


def _stack(cfg, params, x: torch.Tensor, state, m_fn, s_fn,
           remat: bool = False):
    """Every block on x (residual around each), with ``m_fn`` /
    ``s_fn`` the mLSTM and sLSTM runners; with a state, each block
    starts from its entry and writes its final state back. ``remat``
    (no state): each mLSTM block is recomputed in the backward pass, as
    the reference's ``jax.checkpoint`` of its mLSTM scan body; the sLSTM
    blocks are kept."""
    for g, blocks in enumerate(params.mlstm):
        for j, bp in enumerate(blocks):
            if remat:
                x = checkpoint(_mlstm_block, cfg, bp, x, use_reentrant=False)
                continue
            st = None if state is None else \
                (state.mc[g, j], state.mn[g, j], state.mm[g, j])
            out, new = m_fn(cfg, bp, L.rmsnorm(x, bp.norm), st)
            x = x + out
            if state is not None:
                for dst, src in zip(st, new):
                    dst.copy_(src)
        if params.slstm is not None:
            sp = params.slstm[g]
            st = None if state is None else \
                (state.sc[g], state.sn[g], state.sm[g], state.sh[g])
            out, new = s_fn(cfg, sp, L.rmsnorm(x, sp.norm), st)
            x = x + out
            if state is not None:
                for dst, src in zip(st, new):
                    dst.copy_(src)
    return L.rmsnorm(x, params.norm_f)


def forward(cfg, params, tokens, *, mode: str = "train",
            last_only: bool = False, return_hidden: bool = False):
    """Returns (logits, aux = 0), or with ``return_hidden`` the
    mean-pooled final hidden state in fp32. Both modes run the chunked
    mLSTM; in train mode with gradients enabled and ``remat="block"``
    each mLSTM block is recomputed in the backward pass. ``params``: an
    ``XLSTM`` or its training views (``stacked_views``)."""
    x = L.embed(params.embed, tokens, torch_dtype(cfg.dtype))
    remat = mode == "train" and cfg.remat == "block" and \
        torch.is_grad_enabled()
    x = _stack(cfg, params, x, None, mlstm_parallel, slstm_scan, remat)
    if return_hidden:
        return torch.mean(x.float(), dim=1)
    if last_only:
        x = x[:, -1:]
    return L.logits(params.embed, x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)


def prefill(cfg, params: XLSTM, tokens, state: XLSTMState):
    """Run the whole prompt from ``state``; returns (last-token logits
    (B, 1, V), the state, written in place, with length + S)."""
    x = L.embed(params.embed, tokens, torch_dtype(cfg.dtype))
    x = _stack(cfg, params, x, state, mlstm_parallel, slstm_scan)
    lg = L.logits(params.embed, x[:, -1:])
    return lg, dataclasses.replace(state, length=state.length
                                   + tokens.shape[1])


def _step(cfg, params: XLSTM, state: XLSTMState,
          tokens: torch.Tensor) -> torch.Tensor:
    x = L.embed(params.embed, tokens, torch_dtype(cfg.dtype))
    x = _stack(cfg, params, x, state, mlstm_step, slstm_step)
    return L.logits(params.embed, x)


def decode_step(cfg, params: XLSTM, state: XLSTMState, tokens):
    """One token for the whole stack. tokens: (B, 1). Returns (logits
    (B, 1, V), the state, written in place, with length + 1). On the
    card the state's first step is captured as a CUDA graph that its
    later steps replay (``graph.StepGraph``, as hymba's and enc-dec's
    decode): a step is ~2,800 small kernels."""
    logits, graph = G.decode(lambda t, _: _step(cfg, params, state, t),
                             params, state.graph, tokens, state.length)
    return logits, dataclasses.replace(state, length=state.length + 1,
                                       graph=graph)
