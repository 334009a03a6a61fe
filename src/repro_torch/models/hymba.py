"""Hymba: per-block parallel attention heads and Mamba (selective-SSM)
heads (port of ``repro/models/hymba.py``).

Each block normalizes its input once, runs an attention branch and a
selective-SSM branch on the same hidden state, fuses the two by averaging
their re-normalized outputs (the Hymba fusion rule), then a SwiGLU MLP.
Within each group of ``global_every`` layers the last attends globally
and the rest through a sliding window of ``cfg.window`` positions. A
windowed layer's decode cache is a ring buffer of ``window`` slots (slot
= position % window, each slot's absolute position kept beside it, -1
while empty); the SSM branch carries an O(1) state.

Parameters: ``Hymba.embed``, ``.win[g][w]`` (group g's w-th windowed
block), ``.glob[g]`` (its global block), ``.norm_f``; each block holds
``norm1``, ``attn``, ``mamba``, ``norm_attn``, ``norm_ssm``, ``norm2`` and
``mlp`` under the reference's keys. ``a_log`` is held in fp32, as the
reference reads it; the other matrices in ``cfg.dtype``.

Port decisions:

- The SSM scan (``mamba_scan``): within each chunk of 128 positions, a
  log-depth (Hillis-Steele) inclusive scan over the reference's
  ``binop``, the (decay, drive) pairs composed as (a_l a_r, b_l a_r +
  b_r), 7 steps for 128 positions, in fp32, all chunks at once; across
  chunks a loop that carries the state. That is the reference's
  partition (``chunk=128``); its ``lax.associative_scan`` combines in
  another tree (and XLA's ``exp`` rounds otherwise than torch's), so the
  states agree within fp32 rounding. The reference runs this scan
  outside any Pallas kernel; a fused selective-scan kernel is a later
  speed item.
- The cache: ``decode_step`` writes each step's K/V, ring positions and
  SSM states into the cache's tensors in place and returns a
  ``HymbaCache`` over the same tensors with ``length + 1`` (the reference
  returns updated copies); on the card the step is one CUDA graph,
  captured by the cache's first step and replayed (``decode_step``).
  ``prefill`` (in ``models/zoo.py``) returns an empty cache, as the
  reference's does: ``ServeEngine`` fills it by replaying the prompt
  through ``decode_step``. ``cache_spec`` gives the cache's abstract
  tree and partition specs for the dry run (``launch/dryrun.py``).
- Training reads the stacked {reference path: tensor} dict through
  ``stacked_views`` and recomputes each windowed block in the backward
  pass (``remat="block"``), as the reference does; the global blocks
  are kept, and with them every level of their Mamba scan (the
  ``torch.cat`` at each shift).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import graph as G
from repro_torch.models import layers as L
from repro_torch.models.spec import ParamDef, TensorSpec
from repro_torch.models.transformer import (Group, embed_view, layer_tree,
                                            stack_defs, stacked_rows,
                                            torch_dtype)
from repro_torch.sharding.partitioning import P

CONV_K = 4  # depthwise causal conv kernel width


def _dm(cfg) -> int:
    return cfg.ssm_heads * cfg.hd()


def _dt_rank(cfg) -> int:
    return max(1, cfg.d_model // 16)


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------
def mamba_defs(cfg) -> Dict[str, ParamDef]:
    d, dm, n, r = cfg.d_model, _dm(cfg), cfg.ssm_state, _dt_rank(cfg)
    return {
        "in_proj": ParamDef((d, 2, dm), ("embed", None, "heads")),
        "conv_w": ParamDef((CONV_K, dm), (None, "heads"), scale=1.0),
        "conv_b": ParamDef((dm,), ("heads",), init="zeros"),
        "x_proj": ParamDef((dm, r + 2 * n), ("heads", None)),
        "dt_proj": ParamDef((r, dm), (None, "heads")),
        "dt_bias": ParamDef((dm,), ("heads",), init="zeros"),
        "a_log": ParamDef((dm, n), ("heads", None), init="ones",
                          read_as="float32"),
        "d_skip": ParamDef((dm,), ("heads",), init="ones"),
        "out_proj": ParamDef((dm, d), ("heads", "embed")),
    }


def block_defs(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "norm1": ParamDef((d,), ("embed",), init="ones"),
        "attn": L.attn_defs(cfg),
        "mamba": mamba_defs(cfg),
        "norm_attn": ParamDef((d,), ("embed",), init="ones"),
        "norm_ssm": ParamDef((d,), ("embed",), init="ones"),
        "norm2": ParamDef((d,), ("embed",), init="ones"),
        "mlp": L.mlp_defs(cfg),
    }


def group_shape(cfg) -> Tuple[int, int]:
    g = cfg.num_layers // cfg.global_every
    return g, cfg.global_every - 1  # (groups, windowed per group)


def model_defs(cfg) -> Dict[str, Any]:
    g, w = group_shape(cfg)
    return {
        "embed": L.embed_defs(cfg),
        "win": stack_defs(stack_defs(block_defs(cfg), w), g),
        "glob": stack_defs(block_defs(cfg), g),
        "norm_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
    }


class Hymba(nn.Module):
    """The parameters of one model: ``embed``, ``win``, ``glob``,
    ``norm_f``."""

    def __init__(self, cfg, flat: Dict[str, torch.Tensor]):
        """``flat``: {reference path: tensor}, ``win/*`` stacked (G, W,
        ...), ``glob/*`` (G, ...)."""
        super().__init__()
        self.cfg = cfg
        g, w = group_shape(cfg)
        self.embed = Group({"tok": flat["embed/tok"],
                            "unembed": flat["embed/unembed"]})
        self.win = nn.ModuleList(
            nn.ModuleList(Group(layer_tree(flat, "win", (i, j)))
                          for j in range(w)) for i in range(g))
        self.glob = nn.ModuleList(Group(layer_tree(flat, "glob", i))
                                  for i in range(g))
        self.norm_f = nn.Parameter(flat["norm_f"], requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def stacked_views(cfg, flat: Dict[str, torch.Tensor]) -> SimpleNamespace:
    """The training twin of ``Hymba`` (see ``transformer.stacked_views``):
    ``win[g][w]`` reads row (g, w) of each ``win/*`` tensor (G, W, ...),
    ``glob[g]`` row g of each ``glob/*`` (G, ...), so gradients come back
    in those stacked layouts."""
    g, w = group_shape(cfg)
    return SimpleNamespace(embed=embed_view(flat),
                           win=stacked_rows(flat, "win", (g, w)),
                           glob=stacked_rows(flat, "glob", (g,)),
                           norm_f=flat["norm_f"])


# ---------------------------------------------------------------------------
# Mamba branch
# ---------------------------------------------------------------------------
def _ssm_inputs(p, x: torch.Tensor):
    """The two halves of the input projection: (xs, z), each (B, S, dm)."""
    w = p.in_proj.to(x.dtype)                       # (d, 2, dm)
    d, two, dm = w.shape
    xz = (x @ w.reshape(d, two * dm)).reshape(*x.shape[:-1], two, dm)
    return xz[..., 0, :], xz[..., 1, :]


def _conv(p, xs: torch.Tensor, conv_state=None):
    """Causal depthwise conv. xs: (B, S, dm); conv_state: (B, K-1, dm)."""
    b, s, dm = xs.shape
    pad = conv_state if conv_state is not None else \
        xs.new_zeros(b, CONV_K - 1, dm)
    xp = torch.cat([pad.to(xs.dtype), xs], dim=1)
    w = p.conv_w.to(xs.dtype)                       # (K, dm)
    out = xp[:, 0:s] * w[0]
    for j in range(1, CONV_K):
        out = out + xp[:, j:j + s] * w[j]
    out = out + p.conv_b.to(xs.dtype)
    return L.silu(out), xp[:, -(CONV_K - 1):]


def _ssm_coeffs(cfg, p, xc: torch.Tensor):
    """a (decay), bu (drive), each (B, S, dm, N), and C (B, S, N), fp32,
    from the conv output."""
    n, r = cfg.ssm_state, _dt_rank(cfg)
    xdb = xc @ p.x_proj.to(xc.dtype)
    dt_low, bmat, cmat = xdb[..., :r], xdb[..., r:r + n], xdb[..., r + n:]
    dt = L.softplus((dt_low @ p.dt_proj.to(xc.dtype)).float()
                   + p.dt_bias.float())
    a_mat = -torch.exp(p.a_log.float())              # (dm, N)
    a = torch.exp(dt[..., None] * a_mat)              # (B, S, dm, N)
    bu = (dt * xc.float())[..., None] * bmat.float()[:, :, None, :]
    return a, bu, cmat.float()


def _scan_chunks(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the pairs (a_t, b_t) along dim 1 (every chunk of
    dim 0 at once) under the reference's ``binop``, ((a_l, b_l), (a_r,
    b_r)) -> (a_l a_r, b_l a_r + b_r), the state map h -> a h + b applied
    left, then right. Hillis-Steele: ceil(log2 T) steps; after the step of
    shift k each position holds the composition of the 2k positions
    ending at it (fewer near the start)."""
    k, t = 1, a.shape[1]
    while k < t:
        a, b = (torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1),
                torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]],
                          dim=1))
        k *= 2
    return a, b


def mamba_scan(cfg, p, x: torch.Tensor, state=None, chunk: int = 128):
    """Full-sequence selective SSM. Returns (y, (h, conv_state)). The
    sequence must be a multiple of min(chunk, S) long, as the reference
    asserts. Every chunk is scanned at once; then a loop over the chunks
    carries the state, each chunk's states ``cum_a * h + cum_b`` from the
    state before it, as the reference's ``lax.scan`` body computes them."""
    b, s, _ = x.shape
    qc = int(min(chunk, s))
    if s % qc:
        raise ValueError(f"mamba_scan: {s} positions are not a multiple of "
                         f"the {qc}-position chunk")
    xs, z = _ssm_inputs(p, x)
    h0, conv0 = state if state is not None else (None, None)
    xc, conv_state = _conv(p, xs, conv0)
    a, bu, cmat = _ssm_coeffs(cfg, p, xc)
    dm, n = a.shape[2:]
    nc = s // qc
    cum_a, cum_b = _scan_chunks(a.reshape(b * nc, qc, dm, n),
                                bu.reshape(b * nc, qc, dm, n))
    cum_a = cum_a.view(b, nc, qc, dm, n)
    cum_b = cum_b.view(b, nc, qc, dm, n)
    h = h0 if h0 is not None else \
        torch.zeros(b, dm, n, dtype=torch.float32, device=x.device)
    starts = []                       # the state entering each chunk
    for c in range(nc):
        starts.append(h)
        h = cum_a[:, c, -1] * h + cum_b[:, c, -1]
    hs = cum_a * torch.stack(starts, dim=1)[:, :, None] + cum_b
    y = torch.einsum("bsmn,bsn->bsm", hs.view(b, s, dm, n), cmat)
    y = y + p.d_skip.float() * xc.float()
    y = (y * L.silu(z.float())).to(x.dtype)
    return y @ p.out_proj.to(x.dtype), (h, conv_state)


def mamba_step(cfg, p, x: torch.Tensor, state):
    """One-token SSM step. x: (B, 1, d); state = (h, conv_state)."""
    h0, conv0 = state
    xs, z = _ssm_inputs(p, x)
    xc, conv_state = _conv(p, xs, conv0)
    a, bu, cmat = _ssm_coeffs(cfg, p, xc)
    h = a[:, 0] * h0 + bu[:, 0]
    y = torch.einsum("bmn,bn->bm", h, cmat[:, 0])
    y = y + p.d_skip.float() * xc[:, 0].float()
    y = (y * L.silu(z[:, 0].float())).to(x.dtype)
    return (y @ p.out_proj.to(x.dtype))[:, None], (h, conv_state)


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------
def _fuse(bp, attn_out: torch.Tensor, ssm_out: torch.Tensor):
    return 0.5 * (L.rmsnorm(attn_out, bp.norm_attn)
                  + L.rmsnorm(ssm_out, bp.norm_ssm))


def block_seq(cfg, bp, x, positions, *, window: int, mode: str,
              ssm_state=None):
    """Full-sequence block (train / prefill). Returns (x, new_ssm_state).
    ``mode="stream"`` attends through ``attention_stream`` (on the card,
    the flash kernel with this layer's window)."""
    h = L.rmsnorm(x, bp.norm1)
    q, k, v = L.qkv(cfg, bp.attn, h, positions)
    ke, ve = L.expand_kv(cfg, k), L.expand_kv(cfg, v)
    if mode == "stream":
        attn = L.attention_stream(q, ke, ve, causal=True, window=window)
    else:
        attn = L.attention_dense(q, ke, ve, causal=True, window=window)
    attn_out = L.out_proj(cfg, bp.attn, attn)
    ssm_out, new_state = mamba_scan(cfg, bp.mamba, h, ssm_state)
    x = x + _fuse(bp, attn_out, ssm_out)
    x = x + L.mlp(bp.mlp, L.rmsnorm(x, bp.norm2))
    return x, new_state


def block_decode(cfg, bp, x, idx: torch.Tensor, *, kv, kv_positions,
                 ssm_state, window_ring: bool):
    """One-token block at position ``idx`` (a 0-d int64 tensor on x's
    device). Writes the step's K/V (and, on a ring, the slot's position)
    into ``kv`` / ``kv_positions`` in place; returns (x, new_ssm_state)."""
    h = L.rmsnorm(x, bp.norm1)
    positions = idx.expand(x.shape[0], x.shape[1])
    q, k, v = L.qkv(cfg, bp.attn, h, positions)
    ck, cv = kv
    slot = (idx % ck.shape[1] if window_ring else idx).view(1)
    if window_ring:
        kv_positions.index_copy_(0, slot, idx.view(1))
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    cke, cve = L.expand_kv(cfg, ck), L.expand_kv(cfg, cv)
    if window_ring:
        attn = L.attention_dense(q, cke, cve, causal=True, q_offset=idx,
                                 kv_positions=kv_positions)
    else:
        attn = L.attention_dense(q, cke, cve, causal=False, q_offset=idx,
                                 kv_valid_len=idx + 1)
    attn_out = L.out_proj(cfg, bp.attn, attn)
    ssm_out, new_state = mamba_step(cfg, bp.mamba, h, ssm_state)
    x = x + _fuse(bp, attn_out, ssm_out)
    x = x + L.mlp(bp.mlp, L.rmsnorm(x, bp.norm2))
    return x, new_state


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
@dataclass
class HymbaCache:
    wk: torch.Tensor      # (G, W, B, window, kvp, hd) ring buffers
    wv: torch.Tensor
    wpos: torch.Tensor    # (G, W, window) absolute positions (init -1)
    gk: torch.Tensor      # (G, B, max_len, kvp, hd) global layers
    gv: torch.Tensor
    w_ssm: torch.Tensor   # (G, W, B, dm, N) fp32
    w_conv: torch.Tensor  # (G, W, B, K-1, dm)
    g_ssm: torch.Tensor   # (G, B, dm, N) fp32
    g_conv: torch.Tensor  # (G, B, K-1, dm)
    length: int           # tokens already in the cache (a host int)
    # on the card, the decode step captured for these tensors
    graph: Optional[G.StepGraph] = field(default=None, repr=False)


def init_cache(cfg, batch: int, max_len: int, device) -> HymbaCache:
    g, w = group_shape(cfg)
    kv, hd, dm, n = cfg.kvp(), cfg.hd(), _dm(cfg), cfg.ssm_state
    win = min(cfg.window, max_len)
    dt = torch_dtype(cfg.dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)
    return HymbaCache(
        wk=zeros((g, w, batch, win, kv, hd)),
        wv=zeros((g, w, batch, win, kv, hd)),
        wpos=torch.full((g, w, win), -1, dtype=torch.int64, device=device),
        gk=zeros((g, batch, max_len, kv, hd)),
        gv=zeros((g, batch, max_len, kv, hd)),
        w_ssm=zeros((g, w, batch, dm, n), torch.float32),
        w_conv=zeros((g, w, batch, CONV_K - 1, dm)),
        g_ssm=zeros((g, batch, dm, n), torch.float32),
        g_conv=zeros((g, batch, CONV_K - 1, dm)),
        length=0)


def cache_spec(cfg, batch: int, max_len: int, rules):
    """(abstract cache, its partition specs), each a ``HymbaCache`` of the
    reference's shapes and types (``wpos`` int32 and ``length`` an int32
    scalar there; the port holds ``wpos`` in int64 and ``length`` as a
    host int); the attention caches split as ``rules.kv_spec`` splits
    them."""
    g, w = group_shape(cfg)
    kv, hd, dm, n = cfg.kvp(), cfg.hd(), _dm(cfg), cfg.ssm_state
    win = min(cfg.window, max_len)
    dt = torch_dtype(cfg.dtype)
    f32, i32 = torch.float32, torch.int32
    shp = dict(
        wk=((g, w, batch, win, kv, hd), dt),
        wv=((g, w, batch, win, kv, hd), dt),
        wpos=((g, w, win), i32),
        gk=((g, batch, max_len, kv, hd), dt),
        gv=((g, batch, max_len, kv, hd), dt),
        w_ssm=((g, w, batch, dm, n), f32),
        w_conv=((g, w, batch, CONV_K - 1, dm), dt),
        g_ssm=((g, batch, dm, n), f32),
        g_conv=((g, batch, CONV_K - 1, dm), dt),
        length=((), i32))
    logical = dict(
        wk=(None, None, "batch", None, "kv_heads", None),
        wv=(None, None, "batch", None, "kv_heads", None),
        wpos=(None, None, None),
        gk=(None, "batch", None, "kv_heads", None),
        gv=(None, "batch", None, "kv_heads", None),
        w_ssm=(None, None, "batch", "heads", None),
        w_conv=(None, None, "batch", None, "heads"),
        g_ssm=(None, "batch", "heads", None),
        g_conv=(None, "batch", None, "heads"),
        length=())
    spec = {k: rules.spec_for(shp[k][0], lg) for k, lg in logical.items()}
    for k in ("gk", "gv"):
        spec[k] = rules.kv_spec(shp[k][0], logical[k], batch_dim=1,
                                seq_dim=2)
    for k in ("wk", "wv"):
        spec[k] = rules.kv_spec(shp[k][0], logical[k], batch_dim=2,
                                seq_dim=3)
    return (HymbaCache(**{k: TensorSpec(*v) for k, v in shp.items()}),
            HymbaCache(**spec))


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------
def _win_block(cfg, bp, x, positions, mode: str):
    return block_seq(cfg, bp, x, positions, window=cfg.window, mode=mode)[0]


def forward(cfg, params, tokens, *, mode: str = "train",
            last_only: bool = False, return_hidden: bool = False):
    """Returns (logits, aux = 0), or with ``return_hidden`` the
    mean-pooled final hidden state in fp32. mode: "train" (dense
    attention) or "stream" (``attention_stream``). ``params``: a
    ``Hymba`` or its training views (``stacked_views``). In train mode
    with gradients enabled and ``remat="block"``, each windowed block is
    recomputed in the backward pass (``torch.utils.checkpoint``), as the
    reference's ``jax.checkpoint`` of its windowed scan body; the global
    blocks are kept."""
    x = L.embed(params.embed, tokens, torch_dtype(cfg.dtype))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    remat = mode == "train" and cfg.remat == "block" and \
        torch.is_grad_enabled()
    for win, glob in zip(params.win, params.glob):
        for bp in win:
            x = checkpoint(_win_block, cfg, bp, x, positions, mode,
                           use_reentrant=False) if remat else \
                _win_block(cfg, bp, x, positions, mode)
        x, _ = block_seq(cfg, glob, x, positions, window=0, mode=mode)
    x = L.rmsnorm(x, params.norm_f)
    if return_hidden:
        return torch.mean(x.float(), dim=1)
    if last_only:
        x = x[:, -1:]
    return L.logits(params.embed, x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)


def _step(cfg, params: Hymba, cache: HymbaCache, tokens: torch.Tensor,
          idx: torch.Tensor) -> torch.Tensor:
    """One decode step at position ``idx`` (a 0-d int64 tensor), written
    into the cache's tensors in place; returns the logits (B, 1, V).
    Nothing in it reads a value back to the host, so one captured graph
    serves every position."""
    x = L.embed(params.embed, tokens, torch_dtype(cfg.dtype))
    c = cache
    for gi, (win, glob) in enumerate(zip(params.win, params.glob)):
        for wi, bp in enumerate(win):
            x, (h, conv) = block_decode(
                cfg, bp, x, idx, kv=(c.wk[gi, wi], c.wv[gi, wi]),
                kv_positions=c.wpos[gi, wi],
                ssm_state=(c.w_ssm[gi, wi], c.w_conv[gi, wi]),
                window_ring=True)
            c.w_ssm[gi, wi] = h
            c.w_conv[gi, wi] = conv
        x, (h, conv) = block_decode(
            cfg, glob, x, idx, kv=(c.gk[gi], c.gv[gi]), kv_positions=None,
            ssm_state=(c.g_ssm[gi], c.g_conv[gi]), window_ring=False)
        c.g_ssm[gi] = h
        c.g_conv[gi] = conv
    x = L.rmsnorm(x, params.norm_f)
    return L.logits(params.embed, x)


def decode_step(cfg, params: Hymba, cache: HymbaCache, tokens):
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V), the
    cache with the step written in place and length + 1).

    Port decision (speed): on the card a step is a few thousand small
    kernels, so launching them one by one holds the card idle most of
    the time; the cache's first step captures them as one CUDA graph
    (``graph.StepGraph``) that every later step on that cache replays.
    The arithmetic is ``_step``'s either way, which a CPU tensor runs as
    is."""
    idx = cache.length
    if idx >= cache.gk.shape[2]:
        raise ValueError(f"the cache is full ({idx} positions)")
    logits, graph = G.decode(
        lambda t, i: _step(cfg, params, cache, t, i), params, cache.graph,
        tokens, idx)
    return logits, dataclasses.replace(cache, length=idx + 1, graph=graph)
