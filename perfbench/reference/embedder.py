"""The embedder's plain forward: the mean-pooled final hidden state of a
decoder-only transformer (RMSNorm, RoPE, causal multi-head attention,
SwiGLU MLP), in fp32 on the benchmark's own weights, with no kernel, no
cache and no batching tricks. Imports nothing of the program.

``mm`` is the one place every weight product goes through, so a control
can compute them in a lower precision (``reference/controls.py``)."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

EPS = 1e-6


def ieee_fp32() -> None:
    """fp32 products in IEEE fp32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); rotate the two halves of each head by position."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32,
                       device=x.device)[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


@torch.no_grad()
def pooled(weights: Dict[str, torch.Tensor], tokens: torch.Tensor,
           model: dict, mm: Optional[Callable] = None) -> torch.Tensor:
    """(B, S) tokens -> (B, d_model) fp32 mean-pooled embeddings."""
    mm = mm or _matmul
    w = {k: v.float() for k, v in weights.items()}
    n, d, h = model["num_layers"], model["d_model"], model["num_heads"]
    hd, theta = d // h, float(model["rope_theta"])
    b, s = tokens.shape
    x = w["tok"][tokens.long()]
    causal = torch.ones((s, s), dtype=torch.bool,
                        device=x.device).tril()
    for i in range(n):
        a = _rmsnorm(x, w["norm1"][i])
        q = _rope(mm(a, w["wq"][i].reshape(d, h * hd)).reshape(b, s, h, hd),
                  theta)
        k = _rope(mm(a, w["wk"][i].reshape(d, h * hd)).reshape(b, s, h, hd),
                  theta)
        v = mm(a, w["wv"][i].reshape(d, h * hd)).reshape(b, s, h, hd)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        sc = sc.masked_fill(~causal, float("-inf")).softmax(-1)
        o = torch.einsum("bhqk,bkhd->bqhd", sc, v).reshape(b, s, h * hd)
        x = x + mm(o, w["wo"][i].reshape(h * hd, d))
        a = _rmsnorm(x, w["norm2"][i])
        g = mm(a, w["w_gate"][i])
        x = x + mm(g * torch.sigmoid(g) * mm(a, w["w_up"][i]),
                   w["w_down"][i])
    return _rmsnorm(x, w["norm_f"]).mean(1)
