"""The benchmark's adapter to the program under test (``repro_torch``):
the embedder's parameter module built from the benchmark's weights, and
the program's configuration of it. Imported only by the traffic kinds
that drive the program; the reference never imports it."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def embedder_config(model: dict):
    """The program's ``ModelConfig`` of ``model["name"]`` with every width
    the configuration file states, so the file is what both sides run."""
    from repro_torch.configs import get_config
    base = get_config(model["name"])
    keys = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{k: v for k, v in model.items()
                                        if k in keys and k != "name"})


def embedder_params(cfg, weights: Dict[str, torch.Tensor]):
    """The program's parameter module over the benchmark's weights: heads
    zero-padded to the program's padded count (its output projection
    masks them), stacked blocks, the unembedding zero (a pooled embedding
    never reads it)."""
    from repro_torch.models.transformer import Transformer
    hp, kvp = cfg.hp(), cfg.kvp()

    def pad(t: torch.Tensor, dim: int, to: int) -> torch.Tensor:
        if t.shape[dim] == to:
            return t.contiguous()
        shape = list(t.shape)
        shape[dim] = to - shape[dim]
        return torch.cat([t, t.new_zeros(shape)], dim=dim)

    tok = weights["tok"]
    v = cfg.padded_vocab()
    flat = {
        "embed/tok": pad(tok, 0, v),
        "embed/unembed": tok.new_zeros((cfg.d_model, v)),
        "blocks/attn/wq": pad(weights["wq"], 2, hp),
        "blocks/attn/wk": pad(weights["wk"], 2, kvp),
        "blocks/attn/wv": pad(weights["wv"], 2, kvp),
        "blocks/attn/wo": pad(weights["wo"], 1, hp),
        "blocks/mlp/w_gate": weights["w_gate"],
        "blocks/mlp/w_up": weights["w_up"],
        "blocks/mlp/w_down": weights["w_down"],
        "blocks/norm1": weights["norm1"],
        "blocks/norm2": weights["norm2"],
        "norm_f": weights["norm_f"],
    }
    return Transformer(cfg, flat)
