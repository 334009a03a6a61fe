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
  is 2,048 steps of ~40 small kernels in each of six blocks.
- ``prefill`` and ``decode_step`` write the final states into the
  ``XLSTMState``'s tensors in place (the reference returns new ones)
  and return a state over the same tensors; on the card a state's
  decode steps are one captured CUDA graph (``graph.StepGraph``).
- The reference's ``state_spec`` (a partition spec) comes with the
  dry run (ROADMAP queue 1 item 9, second half) and is left out.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import graph as G
from repro_torch.models import layers as L
from repro_torch.models.spec import ParamDef
from repro_torch.models.transformer import (Group, layer_tree, stack_defs,
                                            torch_dtype)

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


def mlstm_zero_state(b: int, h: int, hd: int, device):
    f32 = torch.float32
    return (torch.zeros((b, h, hd, hd), dtype=f32, device=device),
            torch.zeros((b, h, hd), dtype=f32, device=device),
            torch.full((b, h), NEG, dtype=f32, device=device))


def mlstm_parallel(cfg, p, x: torch.Tensor, state=None):
    """Chunked-parallel mLSTM over whole sequences. x: (B, S, d).
    Returns (out, (C, n, m)): C (B, H, hd, hd), n (B, H, hd), m (B, H),
    fp32. S must be a multiple of min(``cfg.mlstm_chunk``, S), as the
    reference asserts."""
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
        mlstm_zero_state(b, h, hd, x.device)

    fcum = torch.cumsum(lf, dim=2)                        # (b, nc, t, h)
    # intra-chunk log weights A[t, s] = F_t - F_s + log i_s  (s <= t)
    a = fcum[:, :, :, None] - fcum[:, :, None] + li[:, :, None]
    causal = torch.ones((qc, qc), dtype=torch.bool, device=x.device).tril()
    a = torch.where(causal[:, :, None], a, NEG)           # (b, nc, t, s, h)
    f_total = fcum[:, :, -1]                              # (b, nc, h)
    wk_log = f_total[:, :, None] - fcum + li              # (b, nc, s, h)
    # the stabiliser entering each chunk, then its end-of-chunk updates
    m_in = []
    for j in range(nc):
        m_in.append(m)
        m = torch.maximum(m + f_total[:, j], wk_log[:, j].amax(dim=1))
    m_in = torch.stack(m_in, dim=1)                       # (b, nc, h)
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
    c_in, n_in = [], []
    for j in range(nc):
        c_in.append(c)
        n_in.append(n)
        c = decay[:, j, :, None, None] * c + kv[:, j]
        n = decay[:, j, :, None] * n + ks[:, j]
    del kv
    c_in, n_in = torch.stack(c_in, dim=1), torch.stack(n_in, dim=1)
    num = (torch.einsum("bctsh,bcshk->bcthk", qkw, v)
           + w_in[..., None] * torch.einsum("bchkv,bcthk->bcthv", c_in, q))
    den = (qkw.sum(dim=3)
           + w_in * torch.einsum("bchk,bcthk->bcth", n_in, q))
    y = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
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
def slstm_zero_state(b: int, h: int, hd: int, device):
    """(c, n, m, h) as the reference starts them: 0, 1e-6, -1e30, 0."""
    zeros = torch.zeros((b, h, hd), dtype=torch.float32, device=device)
    return zeros, zeros + 1e-6, zeros + NEG, zeros.clone()


def _slstm_cell(r: torch.Tensor, wx_t: torch.Tensor, c, n, m, hprev):
    """One sLSTM step. r: (H, 4 * hd, hd), the recurrent weights heads
    first; wx_t: (B, 4, H, hd) the input projection plus bias, fp32."""
    hh, hd = hprev.shape[1:]
    rec = torch.bmm(r, hprev.permute(1, 2, 0))            # (H, 4hd, B)
    g = wx_t + rec.view(hh, 4, hd, -1).permute(3, 1, 0, 2)
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
    _, graph, _ = G.capture(step, wx.device)
    for _ in range(s - 1):
        graph.replay()
    return ys, st


def slstm_scan(cfg, p, x: torch.Tensor, state=None):
    """Whole-sequence sLSTM: the input product outside, the recurrence in
    a loop. Returns (out, (c, n, m, h)), the state fp32 (B, H, hd)."""
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.hd()
    wx = (x @ p.wx.to(x.dtype).reshape(d, 4 * h * hd)).view(
        b, s, 4, h, hd).to(_wide(x)) + p.b.to(_wide(x))
    r = p.r.to(_wide(x)).transpose(0, 1).reshape(h, 4 * hd, hd)
    if state is None:
        state = slstm_zero_state(b, h, hd, x.device)
    scan = _scan_graphed if x.is_cuda and s > 1 else _scan_eager
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


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------
def _stack(cfg, params: XLSTM, x: torch.Tensor, state, m_fn, s_fn):
    """Every block on x (residual around each), with ``m_fn`` /
    ``s_fn`` the mLSTM and sLSTM runners; with a state, each block
    starts from its entry and writes its final state back."""
    for g, blocks in enumerate(params.mlstm):
        for j, bp in enumerate(blocks):
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


def forward(cfg, params: XLSTM, tokens, *, mode: str = "train",
            last_only: bool = False, return_hidden: bool = False):
    """Returns (logits, aux = 0), or with ``return_hidden`` the
    mean-pooled final hidden state in fp32. Both modes run the chunked
    mLSTM (``mode`` selects remat in the reference, for training)."""
    x = L.embed(params.embed, tokens, torch_dtype(cfg.dtype))
    x = _stack(cfg, params, x, None, mlstm_parallel, slstm_scan)
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
