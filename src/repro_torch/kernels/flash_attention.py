"""Blocked flash attention (forward): CUDA kernel wrapper.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (body ``_kernel``); the kernel is
``csrc/flash_attention.cu``. It computes online-softmax attention over
(B, S, H, hd) q, k, v (H already expanded from the kv heads), causal
and sliding-window masks by absolute position, masked scores -1e30,
fp32 m, l and accumulators, the output cast to q's dtype. At the
prefill's shapes it is bound by operations (4*hd*B*H*S^2, half of it
under the causal mask); this first kernel runs its products in fp32 on
the SIMT cores, one block per (b*h, 64 queries), K and V tiles staged in
shared memory, and skips the tiles its mask covers for the whole block.
Any S: the tail past S is masked out, where the TPU kernel asserts
``S % 128 == 0``.

Layout: q, k and v keep their (B, S, H, hd) layout and strides (no
permute); the kernel needs stride 1 in hd and every stride and base
aligned to 4 elements, and a tensor that is not is copied to a
contiguous one first, explicitly. The output is a new contiguous
(B, S, H, hd) tensor. A CPU tensor takes the plain version
``ref.flash_attention``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pairwise_l2 import _cuda_device

launches = 0   # kernel launches since the last reset (plain calls excluded)

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (stride 1 in hd,
    every other stride and the base 4-element aligned), else an explicit
    contiguous copy."""
    ok = (t.stride(3) == 1 and all(s % 4 == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    if ok:
        return t
    return torch.empty(t.shape, dtype=t.dtype,
                       device=t.device).copy_(t)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q, k, v (B, S, H, hd) fp32 or bf16 CUDA tensors of one shape and
    type, hd in ``HEAD_DIMS`` -> (B, S, H, hd) of that type."""
    global launches
    dev = _cuda_device(q)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, hd), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"{name} must match q: {tuple(q.shape)} {q.dtype} on {dev}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device} (the kernel "
                f"takes sq == skv and expanded kv heads)")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    lib = build.library("flash_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        hd, int(q.dtype == torch.bfloat16), int(causal), int(window), scale,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream),
        "flash_attention")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention over (B, S, H, hd): the kernel for CUDA tensors, the plain
    version for CPU tensors (semantics: ``ref.flash_attention``)."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
