"""Decoder-only transformer LM, dense, MoE and VLM-backbone (port of
``repro/models/transformer.py``), with three entry points: ``forward``
(train-style dense attention, or ``mode="stream"``), ``prefill`` (the
prompt through ``attention_stream``, harvesting each layer's K/V into a
decode cache) and ``decode_step`` (one token against the cache). An MoE
block's feed-forward is ``models/moe.py``'s layer, and ``forward``
returns its aux loss summed over the layers.

Parameters live in ``nn.Module``s whose names follow the reference's
keys: ``Transformer.embed.tok``, ``.blocks[i].attn.wq``,
``.blocks[i].mlp.w_gate``, ``.blocks[i].moe.dense.w_up``,
``.blocks[i].norm1``, ``.norm_f``. The reference stacks the blocks'
parameters along a leading (L, ...) axis and scans over it; here block i
holds row i of each stacked tensor (a view, no copy) and ``forward`` is
a plain loop over the layers. Training reads the stacked tensors through
``stacked_views`` instead (see there), and ``forward`` in train mode with
gradients enabled recomputes each block (``remat="block"``) or each group
of ``remat_group`` blocks in the backward pass, as the reference's
``jax.checkpoint`` does: the same values, less memory.

Port decision (serving types): each parameter is held in the type the
reference reads it in (``serving_dtype``), cast once when the parameters
are made or loaded: a matrix in ``cfg.dtype`` (bf16 for every registered
config), exactly the cast the reference makes on every use
(``p["wq"].astype(x.dtype)``), unless its def reads it in fp32
(``ParamDef.read_as``, hymba's ``a_log``); vectors (norm scales, biases)
in fp32. At llama3-8b's width that holds ~16 GB of weights, not the
reference's fp32 32 GB plus per-use casts.

Port decision (cache): ``decode_step`` writes the new K/V into the
cache's tensors in place (the reference returns updated copies) and
returns a ``KVCache`` over the same tensors with ``length + 1``.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import spec as S
from repro_torch.models.moe import moe, moe_defs
from repro_torch.models.spec import ParamDef
from repro_torch.sharding.partitioning import P


# ---------------------------------------------------------------------------
# Param defs (the reference's tree, blocks stacked along "layers")
# ---------------------------------------------------------------------------
def _block_defs(cfg) -> Dict[str, Any]:
    d: Dict[str, Any] = {"attn": L.attn_defs(cfg)}
    n1, n2 = L.norm_def(cfg), L.norm_def(cfg)
    if n1 is not None:
        d["norm1"], d["norm2"] = n1, n2
    if cfg.is_moe:
        d["moe"] = moe_defs(cfg)
    elif cfg.d_ff:
        d["mlp"] = L.mlp_defs(cfg)
    return d


def stack_defs(defs, n: int):
    return {k: (ParamDef((n,) + v.shape, ("layers",) + v.logical,
                         init=v.init, scale=v.scale, read_as=v.read_as)
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
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float64": torch.float64}[name]


def serving_dtype(cfg, d: ParamDef) -> torch.dtype:
    """The type a parameter is held in: the one the reference reads it in.
    A matrix (rank >= 2 per layer) in ``cfg.dtype``, unless its def reads
    it in fp32; a vector (a norm scale, a bias) in fp32, which a vector
    read in the compute type is cast to on use (the same value)."""
    if d.read_as is not None:
        return torch_dtype(d.read_as)
    rank = len(d.shape) - S.n_stacked(d)
    return torch_dtype(cfg.dtype) if rank >= 2 else torch.float32


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Group(nn.Module):
    """A named group of parameters (``attn``, ``mlp``, ``embed``), its
    nested groups (``moe.dense``) as submodules."""

    def __init__(self, tensors: Dict[str, Any]):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, Group(t) if isinstance(t, dict)
                    else _param(t))


def layer_tree(flat: Dict[str, torch.Tensor], prefix: str, index
               ) -> Dict[str, Any]:
    """One layer of a stacked group: every ``prefix/...`` leaf of
    ``flat`` at ``index`` (a view), nested by its path."""
    tree: Dict[str, Any] = {}
    for path, t in flat.items():
        if path.startswith(prefix + "/"):
            S.tree_set(tree, path[len(prefix) + 1:], t[index])
    return tree


class Block(nn.Module):
    def __init__(self, tensors: Dict[str, Any]):
        super().__init__()
        self.attn = Group(tensors["attn"])
        self.mlp = Group(tensors["mlp"]) if "mlp" in tensors else None
        self.moe = Group(tensors["moe"]) if "moe" in tensors else None
        self.norm1 = _param(tensors["norm1"]) if "norm1" in tensors else None
        self.norm2 = _param(tensors["norm2"]) if "norm2" in tensors else None


class Transformer(nn.Module):
    """The parameters of one model: ``embed``, ``blocks``, ``norm_f``."""

    def __init__(self, cfg, flat: Dict[str, torch.Tensor]):
        """``flat``: {reference path: tensor}, blocks stacked (L, ...)."""
        super().__init__()
        self.cfg = cfg
        self.embed = Group({"tok": flat["embed/tok"],
                            "unembed": flat["embed/unembed"]})
        self.blocks = nn.ModuleList(
            Block(layer_tree(flat, "blocks", i))
            for i in range(cfg.num_layers))
        self.norm_f = _param(flat["norm_f"]) if "norm_f" in flat else None

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def _namespace(tree: Dict[str, Any]) -> SimpleNamespace:
    return SimpleNamespace(**{k: _namespace(v) if isinstance(v, dict) else v
                              for k, v in tree.items()})


def _unbind(t: torch.Tensor, depth: int):
    """``t``'s rows over its ``depth`` leading axes, as nested lists of
    ``unbind(0)`` views."""
    rows = t.unbind(0)
    return list(rows) if depth == 1 else [_unbind(r, depth - 1)
                                          for r in rows]


def stacked_rows(flat: Dict[str, torch.Tensor], prefix: str, lead,
                 absent=()):
    """The layers of one stacked group of ``flat`` ({reference path:
    tensor}) as namespaces over ``unbind`` views: a list of ``lead[0]``
    (for ``lead = (G, W)``, a list of G lists of W) whose entry holds
    row i (or (i, j)) of every ``prefix/...`` leaf under its path's
    keys, each name of ``absent`` None where the group has no such leaf.
    ``unbind``'s backward stacks the rows' gradients into the stacked
    tensor's gradient: the reference's stacked layout."""
    rows = {path[len(prefix) + 1:]: _unbind(t, len(lead))
            for path, t in flat.items() if path.startswith(prefix + "/")}

    def layer(index):
        tree: Dict[str, Any] = {}
        for path, r in rows.items():
            for i in index:
                r = r[i]
            S.tree_set(tree, path, r)
        for name in absent:
            tree.setdefault(name, None)
        return _namespace(tree)

    def level(index):
        if len(index) == len(lead):
            return layer(index)
        return [level(index + (i,)) for i in range(lead[len(index)])]
    return level(())


def embed_view(flat: Dict[str, torch.Tensor]) -> SimpleNamespace:
    return SimpleNamespace(tok=flat["embed/tok"],
                           unembed=flat["embed/unembed"])


def stacked_views(cfg, flat: Dict[str, torch.Tensor]) -> SimpleNamespace:
    """The training twin of ``Transformer``: the same attribute tree
    (``embed.tok``, ``blocks[i].attn.wq``, ``norm_f``, absent groups
    None) over plain tensors. ``flat``: {reference path: tensor}, blocks
    stacked (L, ...), as the train step's compute copy holds them. Block
    i reads the i-th of ``unbind(0)`` of each stacked tensor
    (``stacked_rows``), so gradients come back in the reference's
    (L, ...) layout. (``Transformer`` wraps its views in new
    ``nn.Parameter`` leaves, which cut that link.) Each family's module
    has its own ``stacked_views`` after this pattern."""
    return SimpleNamespace(
        embed=embed_view(flat),
        blocks=stacked_rows(flat, "blocks", (cfg.num_layers,),
                            absent=("mlp", "moe", "norm1", "norm2")),
        norm_f=flat.get("norm_f"))


def port_name(path: str, *index: int) -> str:
    """The port's parameter name for a reference path at the stacked
    ``index`` (``blocks/attn/wq`` at layer i -> ``blocks.i.attn.wq``;
    hymba's ``win/attn/wq`` at group g, place w -> ``win.g.w.attn.wq``;
    ``embed/tok`` -> ``embed.tok``)."""
    keys = path.split("/")
    return ".".join([keys[0], *map(str, index), *keys[1:]])


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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_moe:
        out, aux = moe(cfg, bp.moe, h)
        x = x + out
    elif cfg.d_ff:
        x = x + L.mlp(bp.mlp, h)
    return x, aux, new_kv


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

    def run(x, aux, blocks):
        for bp in blocks:
            x, a, _ = _block(cfg, bp, x, positions, mode=mode, window=0)
            aux = aux + a
        return x, aux

    for group, remat in _remat_groups(cfg, list(params.blocks), mode):
        if remat:
            x, aux = checkpoint(run, x, aux, group, use_reentrant=False)
        else:
            x, aux = run(x, aux, group)
    x = L.apply_norm(cfg, params.norm_f, x)
    if last_only:
        x = x[:, -1:]
    return L.logits(params.embed, x), aux


def _remat_groups(cfg, blocks, mode: str):
    """(blocks, recompute?) in order: the reference's grouped remat
    (``remat_group`` g > 1 dividing the layers, scanned layers), else one
    block at a time under ``remat="block"``, in train mode with gradients
    enabled; otherwise all blocks at once, kept."""
    if mode != "train" or not torch.is_grad_enabled():
        return [(blocks, False)]
    g = cfg.remat_group
    if g > 1 and cfg.scan_layers and cfg.num_layers % g == 0:
        return [(blocks[i:i + g], True) for i in range(0, len(blocks), g)]
    if cfg.remat == "block":
        return [([bp], True) for bp in blocks]
    return [(blocks, False)]


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


def cache_spec(cfg, batch: int, max_len: int, rules):
    """(abstract cache, its partition specs), each a ``KVCache``: K and V
    split as ``rules.kv_spec`` splits them; ``length`` the reference's
    int32 scalar (the port keeps it as a host int)."""
    shp = (cfg.num_layers, batch, max_len, cfg.kvp(), cfg.hd())
    dt = torch_dtype(cfg.dtype)
    spec = rules.kv_spec(shp, ("layers", "batch", None, "kv_heads", None),
                         batch_dim=1, seq_dim=2)
    return (KVCache(k=S.TensorSpec(shp, dt), v=S.TensorSpec(shp, dt),
                    length=S.TensorSpec((), torch.int32)),
            KVCache(k=spec, v=spec, length=P()))


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
            x = x + moe(cfg, bp.moe, h2)[0]
        elif cfg.d_ff:
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
