"""Shared transformer layers (port of ``repro/models/layers.py``): norms,
RoPE, GQA attention, SwiGLU MLP, embedding and unembedding.

Attention comes in the reference's three executions of one function:
  * ``attention_dense``  — matmul + masked fp32 softmax (train / forward
    and decode);
  * ``attention_stream`` — forward-only prefill: a CUDA tensor with
    sq == skv takes the hand-written flash kernel
    (``kernels/flash_attention.py``), anything else the reference's
    online-softmax loop over KV chunks;
  * decode — ``attention_dense`` of one query against the cache.
Parameters are read as the modules hold them: matrices in the serving
type (``cfg.dtype``), norm scales in fp32 (see ``models/transformer.py``);
training's compute copy holds every parameter in ``cfg.dtype``. The
reference threads a ``shard`` hook (a sharding constraint by logical
axes) through every layer; on one card a constraint splits nothing, so
the layers take none, and ``no_shard`` is the reference's default hook
for code written against it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

import repro_torch

from repro_torch.kernels import ops
from repro_torch.models.spec import ParamDef


def no_shard(x, *logical):
    return x


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, the type the reference computes norms, scores and the
    loss in; fp64 stays fp64 (the float64 reference of the training
    checks)."""
    return x if x.dtype == torch.float64 else x.float()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    x = wide(x)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
    return (x * wide(scale)).to(dt)


def nonparam_ln(x: torch.Tensor) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale, no bias)."""
    dt = x.dtype
    x = wide(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + 1e-6)).to(dt)


def norm_def(cfg) -> Optional[ParamDef]:
    if cfg.norm == "nonparam_ln":
        return None
    return ParamDef((cfg.d_model,), ("embed",), init="ones")


def apply_norm(cfg, scale, x: torch.Tensor) -> torch.Tensor:
    return nonparam_ln(x) if scale is None else rmsnorm(x, scale)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Angles in
    fp32, as the reference computes them."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention. Heads are padded to cfg.hp() / cfg.kvp(); padded heads are
# masked in the output projection, so the math equals the unpadded arch.
# ---------------------------------------------------------------------------
def attn_defs(cfg) -> Dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.hd()
    return {
        "wq": ParamDef((d, cfg.hp(), hd), ("embed", "heads", None)),
        "wk": ParamDef((d, cfg.kvp(), hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, cfg.kvp(), hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((cfg.hp(), hd, d), ("heads", None, "embed")),
    }


def head_mask(cfg, device=None) -> torch.Tensor:
    """(hp,) 1.0 for real heads, 0.0 for padding heads."""
    return (torch.arange(cfg.hp(), device=device)
            < cfg.num_heads).to(torch.float32)


def head_map(cfg, device=None) -> torch.Tensor:
    """(hp,) index of the kv head serving each q head. Real heads keep the
    unpadded arch's grouping (i // (H/Kv)); padding heads clamp to the
    last kv head (their output is masked anyway)."""
    g = max(1, cfg.num_heads // cfg.num_kv_heads)
    return torch.clamp_max(torch.arange(cfg.hp(), device=device) // g,
                           cfg.kvp() - 1)


def expand_kv(cfg, k: torch.Tensor) -> torch.Tensor:
    """(B, S, kvp, hd) -> (B, S, hp, hd) by a static gather (a new
    contiguous tensor); ``k`` itself where ``head_map`` is the identity
    (as many kv heads as q heads, each its own group), which spares a
    decode step a copy of every cache it reads."""
    if cfg.kvp() == cfg.hp() and cfg.num_heads < 2 * cfg.num_kv_heads:
        return k
    return k[:, :, head_map(cfg, k.device), :]


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): (B, S, d) x (d, h, k) -> (B, S, h, k)."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def qkv(cfg, p, x: torch.Tensor, positions: Optional[torch.Tensor]):
    q = proj(x, p.wq.to(x.dtype))
    k = proj(x, p.wk.to(x.dtype))
    v = proj(x, p.wv.to(x.dtype))
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_valid_len: Optional[int] = None,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Full-width attention. q/k/v: (B, S, hp, hd), kv heads expanded with
    ``expand_kv`` first. Scores and the softmax-weighted sum of V in fp32
    (products of the inputs, summed in fp32), output in q's dtype.

    ``q_offset``: absolute position of q[0] (decode: the cache length).
    ``kv_valid_len``: mask out cache positions >= this.
    ``kv_positions``: (Skv,) absolute positions of the cache slots;
    entries < 0 are invalid."""
    sq, hd = q.shape[1], q.shape[3]
    skv = k.shape[1]
    dev = q.device
    scores = torch.einsum("bqhd,bshd->bhqs", wide(q), wide(k))
    scores = scores * (1.0 / math.sqrt(hd))
    qpos = torch.arange(sq, device=dev) + q_offset
    if kv_positions is None:
        kpos = torch.arange(skv, device=dev)
        mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    else:
        kpos = kv_positions
        mask = (kpos >= 0)[None, :] & torch.ones((sq, 1), dtype=torch.bool,
                                                  device=dev)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    if kv_valid_len is not None:
        mask &= kpos[None, :] < kv_valid_len
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", w, wide(v))
    return out.to(q.dtype)


def attention_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     chunk: int = 1024) -> torch.Tensor:
    """Forward-only attention that never holds the (Sq, Skv) scores.
    q/k/v: (B, S, hp, hd), kv pre-expanded.

    A CUDA tensor with sq == skv takes the flash kernel
    (``ops.flash_attention``); anything else takes the reference's
    online-softmax loop over KV chunks, whose live memory is one
    (Sq, chunk) tile of scores per head, and which needs skv to be a
    multiple of min(chunk, skv), as the reference's does."""
    if repro_torch.on_card(q) and q.shape[1] == k.shape[1]:
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"attention_stream: {skv} keys are not a multiple "
                         f"of the {chunk}-key chunk")
    dev = q.device
    qf = q.float()
    qpos = torch.arange(sq, device=dev)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((b, h, sq), -math.inf, device=dev)
    l = torch.zeros((b, h, sq), device=dev)
    acc = torch.zeros((b, h, sq, hd), device=dev)
    for start in range(0, skv, chunk):
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        scores = torch.einsum("bqhd,bshd->bhqs", qf, kb) * scale
        kpos = start + torch.arange(chunk, device=dev)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, -1e30))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqs,bshd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)     # (b, sq, h, hd)


def out_proj(cfg, p, attn_out: torch.Tensor) -> torch.Tensor:
    """Masks padding heads, then projects back to d_model."""
    if cfg.hp() != cfg.num_heads:
        attn_out = attn_out * head_mask(cfg, attn_out.device)[
            None, None, :, None].to(attn_out.dtype)
    wo = p.wo.to(attn_out.dtype)
    h, k, d = wo.shape
    return attn_out.reshape(*attn_out.shape[:-2], h * k) @ wo.reshape(h * k,
                                                                       d)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_defs(cfg, d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "ff")),
        "w_up": ParamDef((d, f), ("embed", "ff")),
        "w_down": ParamDef((f, d), ("ff", "embed")),
    }


class _Logistic(torch.autograd.Function):
    """The logistic with JAX's derivative. Autograd through the
    expansion 1 / (1 + exp(-x)) multiplies a zero gradient by
    exp(-x) = inf where x < -88 (fp32; -709 in fp64), a NaN that reaches
    every parameter before it; ``lax.logistic``'s derivative is
    g * (s * logistic(-x)), finite everywhere."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * (s * torch.reciprocal(1 + torch.exp(x)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA evaluates it: the logistic expanded to
    1 / (1 + exp(-x)), every operation rounded to x's dtype (for bf16
    that differs from ``torch.sigmoid``, which rounds once); its
    gradient is ``lax.logistic``'s (``_Logistic``)."""
    return _Logistic.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: x * logistic(x), each
    rounded to x's dtype (``sigmoid``)."""
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (``F.softplus`` returns x itself above its threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    g = x @ p.w_gate.to(x.dtype)
    u = x @ p.w_up.to(x.dtype)
    return (silu(g) * u) @ p.w_down.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_defs(cfg) -> Dict[str, ParamDef]:
    v = cfg.padded_vocab()
    return {
        "tok": ParamDef((v, cfg.d_model), ("vocab", "fsdp")),
        "unembed": ParamDef((cfg.d_model, v), ("fsdp", "vocab")),
    }


def embed(p, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p.tok[tokens].to(dtype)


def logits(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p.unembed.to(x.dtype)
