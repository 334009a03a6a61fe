"""Encoder-decoder transformer, the seamless-m4t backbone (port of
``repro/models/encdec.py``).

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, F, d_model) and attends over them
without a mask. The decoder is a text LM: causal self-attention, then
cross-attention to the encoder's output, then a SwiGLU MLP. Its decode
cache holds the self-attention K/V (growing) and the cross-attention K/V
(computed once from the encoder's output).

Parameters: ``EncDec.embed``, ``.enc[i]``, ``.dec[i]`` (with ``norm_x``
and ``xattn`` beside the encoder block's ``norm1``, ``attn``, ``norm2``,
``mlp``), ``.norm_enc_f``, ``.norm_f``, under the reference's keys.

Attention: the encoder and the cross-attention take ``attention_dense``
(non-causal, and the cross-attention's queries and keys differ in
length); the decoder's self-attention takes ``attention_stream`` in
``mode="stream"``, which on the card is the flash kernel.

Port decisions: ``build_cross_cache`` writes the cross K/V into the
cache's tensors and ``decode_step`` the step's self-attention K/V, in
place (the reference returns new ones); on the card a cache's first
decode step is captured as a CUDA graph that its later steps replay
(``graph.StepGraph``), as hymba's is. ``prefill`` (in ``models/zoo.py``)
returns a cache of length 0 holding only the cross K/V, as the
reference's does: ``ServeEngine`` fills the self-attention K/V by
replaying the prompt through ``decode_step``. ``cache_spec`` gives the
cache's abstract tree and partition specs for the dry run
(``launch/dryrun.py``).

Training reads the stacked {reference path: tensor} dict through
``stacked_views`` and recomputes every encoder and decoder block in the
backward pass (``remat="block"``), as the reference does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import graph as G
from repro_torch.models import layers as L
from repro_torch.models.spec import ParamDef, TensorSpec
from repro_torch.models.transformer import (Group, _positions, embed_view,
                                            layer_tree, stack_defs,
                                            stacked_rows, torch_dtype)
from repro_torch.sharding.partitioning import P


def _enc_block_defs(cfg) -> Dict[str, Any]:
    return {
        "norm1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "attn": L.attn_defs(cfg),
        "norm2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "mlp": L.mlp_defs(cfg),
    }


def _dec_block_defs(cfg) -> Dict[str, Any]:
    d = _enc_block_defs(cfg)
    d["norm_x"] = ParamDef((cfg.d_model,), ("embed",), init="ones")
    d["xattn"] = L.attn_defs(cfg)
    return d


def model_defs(cfg) -> Dict[str, Any]:
    return {
        "embed": L.embed_defs(cfg),
        "enc": stack_defs(_enc_block_defs(cfg), cfg.enc_layers),
        "dec": stack_defs(_dec_block_defs(cfg), cfg.num_layers),
        "norm_enc_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "norm_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
    }


class EncDec(nn.Module):
    """The parameters of one model: ``embed``, ``enc``, ``dec``,
    ``norm_enc_f``, ``norm_f``."""

    def __init__(self, cfg, flat: Dict[str, torch.Tensor]):
        """``flat``: {reference path: tensor}, ``enc/*`` and ``dec/*``
        stacked (L, ...)."""
        super().__init__()
        self.cfg = cfg
        self.embed = Group({"tok": flat["embed/tok"],
                            "unembed": flat["embed/unembed"]})
        self.enc = nn.ModuleList(Group(layer_tree(flat, "enc", i))
                                 for i in range(cfg.enc_layers))
        self.dec = nn.ModuleList(Group(layer_tree(flat, "dec", i))
                                 for i in range(cfg.num_layers))
        self.norm_enc_f = nn.Parameter(flat["norm_enc_f"],
                                       requires_grad=False)
        self.norm_f = nn.Parameter(flat["norm_f"], requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def stacked_views(cfg, flat: Dict[str, torch.Tensor]) -> SimpleNamespace:
    """The training twin of ``EncDec`` (see ``transformer.stacked_views``):
    ``enc[i]`` and ``dec[i]`` read row i of each ``enc/*`` and ``dec/*``
    tensor (L, ...), so gradients come back in those stacked layouts."""
    return SimpleNamespace(
        embed=embed_view(flat),
        enc=stacked_rows(flat, "enc", (cfg.enc_layers,)),
        dec=stacked_rows(flat, "dec", (cfg.num_layers,)),
        norm_enc_f=flat["norm_enc_f"], norm_f=flat["norm_f"])


def _remat(cfg, mode: str) -> bool:
    """Recompute each block in the backward pass: the reference's
    ``jax.checkpoint`` of both scan bodies under ``remat="block"`` in
    train mode (here also only with gradients enabled)."""
    return mode == "train" and cfg.remat == "block" and \
        torch.is_grad_enabled()


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------
def _enc_block(cfg, bp, x: torch.Tensor, positions) -> torch.Tensor:
    h = L.rmsnorm(x, bp.norm1)
    q, k, v = L.qkv(cfg, bp.attn, h, positions)
    attn = L.attention_dense(q, L.expand_kv(cfg, k), L.expand_kv(cfg, v),
                             causal=False)
    x = x + L.out_proj(cfg, bp.attn, attn)
    return x + L.mlp(bp.mlp, L.rmsnorm(x, bp.norm2))


def encode(cfg, params, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, F, d) stub frontend embeddings -> encoder states, in
    ``cfg.dtype``; ``remat`` recomputes each block in the backward pass."""
    x = frames.to(torch_dtype(cfg.dtype))
    positions = _positions(x)
    for bp in params.enc:
        x = checkpoint(_enc_block, cfg, bp, x, positions,
                       use_reentrant=False) if remat else \
            _enc_block(cfg, bp, x, positions)
    return L.rmsnorm(x, params.norm_enc_f)


def _cross(cfg, bp, x: torch.Tensor, enc_kv) -> torch.Tensor:
    """Cross-attention (no RoPE) to precomputed encoder K/V."""
    h = L.rmsnorm(x, bp.norm_x)
    q = L.proj(h, bp.xattn.wq.to(h.dtype))
    ek, ev = enc_kv
    attn = L.attention_dense(q, L.expand_kv(cfg, ek), L.expand_kv(cfg, ev),
                             causal=False)
    return x + L.out_proj(cfg, bp.xattn, attn)


def _enc_kv(cfg, bp, enc_out: torch.Tensor):
    return (L.proj(enc_out, bp.xattn.wk.to(enc_out.dtype)),
            L.proj(enc_out, bp.xattn.wv.to(enc_out.dtype)))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _dec_block(cfg, bp, x: torch.Tensor, enc_out: torch.Tensor, positions,
               mode: str) -> torch.Tensor:
    h = L.rmsnorm(x, bp.norm1)
    q, k, v = L.qkv(cfg, bp.attn, h, positions)
    ke, ve = L.expand_kv(cfg, k), L.expand_kv(cfg, v)
    if mode == "stream":
        attn = L.attention_stream(q, ke, ve, causal=True)
    else:
        attn = L.attention_dense(q, ke, ve, causal=True)
    x = x + L.out_proj(cfg, bp.attn, attn)
    x = _cross(cfg, bp, x, _enc_kv(cfg, bp, enc_out))
    return x + L.mlp(bp.mlp, L.rmsnorm(x, bp.norm2))


def forward(cfg, params, tokens, frames, *, mode: str = "train",
            last_only: bool = False, return_hidden: bool = False):
    """Returns (logits, aux = 0); with ``return_hidden`` the platform's
    embedding for enc-dec: the mean-pooled encoder states in fp32. mode:
    "train" (dense self-attention) or "stream" (``attention_stream``).
    ``params``: an ``EncDec`` or its training views (``stacked_views``);
    under ``_remat`` every encoder and decoder block is recomputed in the
    backward pass."""
    remat = _remat(cfg, mode)
    enc_out = encode(cfg, params, frames, remat=remat)
    if return_hidden:
        return torch.mean(enc_out.float(), dim=1)
    x = L.embed(params.embed, tokens, torch_dtype(cfg.dtype))
    positions = _positions(x)
    for bp in params.dec:
        x = checkpoint(_dec_block, cfg, bp, x, enc_out, positions, mode,
                       use_reentrant=False) if remat else \
            _dec_block(cfg, bp, x, enc_out, positions, mode)
    x = L.rmsnorm(x, params.norm_f)
    if last_only:
        x = x[:, -1:]
    return L.logits(params.embed, x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
@dataclass
class EncDecCache:
    k: torch.Tensor    # (L, B, max_len, kvp, hd) self-attention
    v: torch.Tensor
    xk: torch.Tensor   # (L, B, F, kvp, hd) cross-attention (static)
    xv: torch.Tensor
    length: int        # tokens already in the cache (a host int)
    # on the card, the decode step captured for these tensors
    graph: Optional[G.StepGraph] = field(default=None, repr=False)


def init_cache(cfg, batch: int, max_len: int, device) -> EncDecCache:
    kv, hd, lyr = cfg.kvp(), cfg.hd(), cfg.num_layers
    dt = torch_dtype(cfg.dtype)

    def zeros(n):
        return torch.zeros((lyr, batch, n, kv, hd), dtype=dt, device=device)
    return EncDecCache(k=zeros(max_len), v=zeros(max_len),
                       xk=zeros(cfg.frontend_tokens),
                       xv=zeros(cfg.frontend_tokens), length=0)


def cache_spec(cfg, batch: int, max_len: int, rules):
    """(abstract cache, its partition specs), each an ``EncDecCache``: the
    self- and cross-attention K/V split as ``rules.kv_spec`` splits
    them; ``length`` the reference's int32 scalar (a host int here)."""
    kv, hd, lyr = cfg.kvp(), cfg.hd(), cfg.num_layers
    dt = torch_dtype(cfg.dtype)
    lg = (None, "batch", None, "kv_heads", None)
    shp = {"k": (lyr, batch, max_len, kv, hd),
           "v": (lyr, batch, max_len, kv, hd),
           "xk": (lyr, batch, cfg.frontend_tokens, kv, hd),
           "xv": (lyr, batch, cfg.frontend_tokens, kv, hd)}
    return (EncDecCache(**{k: TensorSpec(s, dt) for k, s in shp.items()},
                        length=TensorSpec((), torch.int32)),
            EncDecCache(**{k: rules.kv_spec(s, lg, batch_dim=1, seq_dim=2)
                           for k, s in shp.items()}, length=P()))


def build_cross_cache(cfg, params: EncDec, frames: torch.Tensor,
                      cache: EncDecCache) -> EncDecCache:
    """Encode the frames once and write every layer's cross-attention K/V
    into the cache."""
    enc_out = encode(cfg, params, frames)
    for i, bp in enumerate(params.dec):
        ek, ev = _enc_kv(cfg, bp, enc_out)
        cache.xk[i] = ek.to(cache.xk.dtype)
        cache.xv[i] = ev.to(cache.xv.dtype)
    return cache


def _step(cfg, params: EncDec, cache: EncDecCache, tokens: torch.Tensor,
          idx: torch.Tensor) -> torch.Tensor:
    """One decode step at position ``idx`` (a 0-d int64 tensor), the
    self-attention K/V written into the cache in place; returns the
    logits (B, 1, V). Nothing in it reads a value back to the host."""
    x = L.embed(params.embed, tokens, torch_dtype(cfg.dtype))
    positions = idx.expand(*tokens.shape)
    slot = idx.view(1)
    for i, bp in enumerate(params.dec):
        h = L.rmsnorm(x, bp.norm1)
        q, k, v = L.qkv(cfg, bp.attn, h, positions)
        ck, cv = cache.k[i], cache.v[i]
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        attn = L.attention_dense(q, L.expand_kv(cfg, ck),
                                 L.expand_kv(cfg, cv), causal=False,
                                 q_offset=idx, kv_valid_len=idx + 1)
        x = x + L.out_proj(cfg, bp.attn, attn)
        x = _cross(cfg, bp, x, (cache.xk[i], cache.xv[i]))
        x = x + L.mlp(bp.mlp, L.rmsnorm(x, bp.norm2))
    x = L.rmsnorm(x, params.norm_f)
    return L.logits(params.embed, x)


def decode_step(cfg, params: EncDec, cache: EncDecCache, tokens):
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V), the
    cache with the step written in place and length + 1)."""
    idx = cache.length
    if idx >= cache.k.shape[2]:
        raise ValueError(f"the cache is full ({idx} positions)")
    logits, graph = G.decode(
        lambda t, i: _step(cfg, params, cache, t, i), params, cache.graph,
        tokens, idx)
    return logits, dataclasses.replace(cache, length=idx + 1, graph=graph)
