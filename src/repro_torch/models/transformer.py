"""Decoder-only transformer LM, dense and VLM-backbone (port of
``repro/models/transformer.py``), with three entry points: ``forward``
(train-style dense attention, or ``mode="stream"``), ``prefill`` (the
prompt through ``attention_stream``, harvesting each layer's K/V into a
decode cache) and ``decode_step`` (one token against the cache).

Parameters live in ``nn.Module``s whose names follow the reference's
keys: ``Transformer.embed.tok``, ``.blocks[i].attn.wq``,
``.blocks[i].mlp.w_gate``, ``.blocks[i].norm1``, ``.norm_f``. The
reference stacks the blocks' parameters along a leading (L, ...) axis
and scans over it; here block i holds row i of each stacked tensor (a
view, no copy) and ``forward`` is a plain loop over the layers (remat is
for training).

Port decision (serving types): each matrix is held in ``cfg.dtype``
(bf16 for every registered config), cast once when the parameters are
made or loaded; that is exactly the cast the reference makes on every use
(``p["wq"].astype(x.dtype)``). Norm scales stay fp32, as ``rmsnorm``
reads them. At llama3-8b's width that holds ~16 GB of weights, not the
reference's fp32 32 GB plus per-use casts.

Port decision (cache): ``decode_step`` writes the new K/V into the
cache's tensors in place (the reference returns updated copies) and
returns a ``KVCache`` over the same tensors with ``length + 1``.

MoE blocks wait for ``models/moe.py`` (ROADMAP queue 1 item 6) and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.spec import ParamDef

MOE_TODO = "MoE blocks are not ported yet: ROADMAP queue 1 item 6, MoE " \
           "(models/moe.py)"


# ---------------------------------------------------------------------------
# Param defs (the reference's tree, blocks stacked along "layers")
# ---------------------------------------------------------------------------
def _block_defs(cfg) -> Dict[str, Any]:
    d: Dict[str, Any] = {"attn": L.attn_defs(cfg)}
    n1, n2 = L.norm_def(cfg), L.norm_def(cfg)
    if n1 is not None:
        d["norm1"], d["norm2"] = n1, n2
    if cfg.is_moe:
        raise NotImplementedError(MOE_TODO)
    if cfg.d_ff:
        d["mlp"] = L.mlp_defs(cfg)
    return d


def stack_defs(defs, n: int):
    return {k: (ParamDef((n,) + v.shape, ("layers",) + v.logical,
                         init=v.init, scale=v.scale)
                if isinstance(v, ParamDef) else stack_defs(v, n))
            for k, v in defs.items()}


def model_defs(cfg) -> Dict[str, Any]:
    d: Dict[str, Any] = {"embed": L.embed_defs(cfg)}
    d["blocks"] = stack_defs(_block_defs(cfg), cfg.num_layers)
    nf = L.norm_def(cfg)
    if nf is not None:
        d["norm_f"] = nf
    return d


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def serving_dtype(cfg, d: ParamDef) -> torch.dtype:
    """A matrix (rank >= 2 per layer) is held in ``cfg.dtype``, a vector
    (a norm scale) in fp32."""
    rank = len(d.shape) - (d.logical[0] == "layers")
    return torch_dtype(cfg.dtype) if rank >= 2 else torch.float32


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class _Group(nn.Module):
    """A named group of parameters (``attn``, ``mlp``, ``embed``)."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, _param(t))


class Block(nn.Module):
    def __init__(self, tensors: Dict[str, Any]):
        super().__init__()
        self.attn = _Group(tensors["attn"])
        self.mlp = _Group(tensors["mlp"]) if "mlp" in tensors else None
        self.norm1 = _param(tensors["norm1"]) if "norm1" in tensors else None
        self.norm2 = _param(tensors["norm2"]) if "norm2" in tensors else None


class Transformer(nn.Module):
    """The parameters of one model: ``embed``, ``blocks``, ``norm_f``."""

    def __init__(self, cfg, flat: Dict[str, torch.Tensor]):
        """``flat``: {reference path: tensor}, blocks stacked (L, ...)."""
        super().__init__()
        self.cfg = cfg
        self.embed = _Group({"tok": flat["embed/tok"],
                             "unembed": flat["embed/unembed"]})
        blocks = []
        for i in range(cfg.num_layers):
            tree: Dict[str, Any] = {}
            for path, t in flat.items():
                if path.startswith("blocks/"):
                    keys = path.split("/")[1:]
                    node = tree
                    for key in keys[:-1]:
                        node = node.setdefault(key, {})
                    node[keys[-1]] = t[i]
            blocks.append(Block(tree))
        self.blocks = nn.ModuleList(blocks)
        self.norm_f = _param(flat["norm_f"]) if "norm_f" in flat else None

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def port_name(path: str, layer: Optional[int] = None) -> str:
    """The port's parameter name for a reference path (``blocks/attn/wq``
    at layer i -> ``blocks.i.attn.wq``; ``embed/tok`` -> ``embed.tok``)."""
    keys = path.split("/")
    if keys[0] == "blocks":
        keys.insert(1, str(layer))
    return ".".join(keys)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _block(cfg, bp: Block, x, positions, *, mode: str, window: int,
           kv_cache=None, kv_index: int = 0):
    """One transformer block. Returns (x, aux, new_kv)."""
    h = L.apply_norm(cfg, bp.norm1, x)
    q, k, v = L.qkv(cfg, bp.attn, h, positions)
    new_kv = None
    if mode == "decode":
        ck, cv = kv_cache
        ck[:, kv_index:kv_index + k.shape[1]] = k.to(ck.dtype)
        cv[:, kv_index:kv_index + v.shape[1]] = v.to(cv.dtype)
        new_kv = (ck, cv)
        attn = L.attention_dense(q, L.expand_kv(cfg, ck),
                                 L.expand_kv(cfg, cv), causal=False,
                                 window=window, q_offset=kv_index,
                                 kv_valid_len=kv_index + 1)
    elif mode == "stream":
        attn = L.attention_stream(q, L.expand_kv(cfg, k),
                                  L.expand_kv(cfg, v), causal=True,
                                  window=window)
    else:  # train / dense prefill
        attn = L.attention_dense(q, L.expand_kv(cfg, k),
                                 L.expand_kv(cfg, v), causal=True,
                                 window=window)
    x = x + L.out_proj(cfg, bp.attn, attn)
    h = L.apply_norm(cfg, bp.norm2, x)
    if cfg.is_moe:
        raise NotImplementedError(MOE_TODO)
    if cfg.d_ff:
        x = x + L.mlp(bp.mlp, h)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new_kv


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------
def embed_inputs(cfg, params: Transformer, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor], dtype):
    x = L.embed(params.embed, tokens, dtype)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(dtype), x], dim=1)
    return x


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def forward(cfg, params: Transformer, tokens, *, frontend_embeds=None,
            mode: str = "train", last_only: bool = False):
    """Returns (logits, aux_loss). mode: "train" (dense attention) or
    "stream" (``attention_stream``)."""
    if cfg.window:
        raise ValueError("windowed archs use their own module (hymba)")
    dtype = torch_dtype(cfg.dtype)
    x = embed_inputs(cfg, params, tokens, frontend_embeds, dtype)
    positions = _positions(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in params.blocks:
        x, a, _ = _block(cfg, bp, x, positions, mode=mode, window=0)
        aux = aux + a
    x = L.apply_norm(cfg, params.norm_f, x)
    if last_only:
        x = x[:, -1:]
    return L.logits(params.embed, x), aux


def pooled_embedding(cfg, params: Transformer, tokens, *,
                     frontend_embeds=None) -> torch.Tensor:
    """Mean-pooled final hidden state, fp32: the platform's embedding."""
    dtype = torch_dtype(cfg.dtype)
    x = embed_inputs(cfg, params, tokens, frontend_embeds, dtype)
    positions = _positions(x)
    for bp in params.blocks:
        x, _, _ = _block(cfg, bp, x, positions, mode="train",
                         window=cfg.window)
    x = L.apply_norm(cfg, params.norm_f, x)
    return torch.mean(x.float(), dim=1)


@dataclass
class KVCache:
    k: torch.Tensor    # (L, B, max_len, kvp, hd) in cfg.dtype
    v: torch.Tensor
    length: int        # tokens already in the cache (a host int)


def init_cache(cfg, batch: int, max_len: int, device) -> KVCache:
    shp = (cfg.num_layers, batch, max_len, cfg.kvp(), cfg.hd())
    dt = torch_dtype(cfg.dtype)
    return KVCache(k=torch.zeros(shp, dtype=dt, device=device),
                   v=torch.zeros(shp, dtype=dt, device=device), length=0)


def prefill(cfg, params: Transformer, tokens, max_len: int, *,
            frontend_embeds=None):
    """Run the prompt through ``attention_stream`` (on the card, the flash
    kernel) and harvest each layer's K/V into a decode cache of
    ``max_len`` positions. Returns (last-token logits (B, 1, V), KVCache)."""
    dtype = torch_dtype(cfg.dtype)
    x = embed_inputs(cfg, params, tokens, frontend_embeds, dtype)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} positions exceeds max_len "
                         f"{max_len}")
    positions = _positions(x)
    cache = init_cache(cfg, b, max_len, x.device)
    for i, bp in enumerate(params.blocks):
        h = L.apply_norm(cfg, bp.norm1, x)
        q, k, v = L.qkv(cfg, bp.attn, h, positions)
        attn = L.attention_stream(q, L.expand_kv(cfg, k),
                                  L.expand_kv(cfg, v), causal=True)
        x = x + L.out_proj(cfg, bp.attn, attn)
        h2 = L.apply_norm(cfg, bp.norm2, x)
        if cfg.is_moe:
            raise NotImplementedError(MOE_TODO)
        if cfg.d_ff:
            x = x + L.mlp(bp.mlp, h2)
        cache.k[i, :, :s] = k.to(dtype)
        cache.v[i, :, :s] = v.to(dtype)
    x = L.apply_norm(cfg, params.norm_f, x)
    lg = L.logits(params.embed, x[:, -1:])
    cache.length = s
    return lg, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def decode_step(cfg, params: Transformer, cache: KVCache, tokens):
    """One decode step. tokens: (B, 1). Returns (logits (B, 1, V), the
    cache with the step's K/V written in place and length + 1)."""
    dtype = torch_dtype(cfg.dtype)
    idx = cache.length
    if idx >= cache.k.shape[2]:
        raise ValueError(f"the cache is full ({idx} positions)")
    x = L.embed(params.embed, tokens, dtype)
    positions = torch.full(tuple(tokens.shape), idx, dtype=torch.int64,
                           device=x.device)
    for i, bp in enumerate(params.blocks):
        x, _, _ = _block(cfg, bp, x, positions, mode="decode", window=0,
                         kv_cache=(cache.k[i], cache.v[i]), kv_index=idx)
    x = L.apply_norm(cfg, params.norm_f, x)
    return L.logits(params.embed, x), KVCache(k=cache.k, v=cache.v,
                                              length=idx + 1)
