"""Blocked flash attention (forward): CUDA kernel wrappers.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (body ``_kernel``). It computes online-softmax
attention over (B, S, H, hd) q, k, v (H already expanded from the kv
heads), causal and sliding-window masks by absolute position, masked
scores -1e30, fp32 m, l and accumulators, the output cast to q's dtype.
At the prefill's shapes it is bound by operations (4*hd*B*H*S^2, half of
it under the causal mask). Any S: the tail past S is masked out, where
the TPU kernel asserts ``S % 128 == 0``.

Two kernels, and the route is chosen by type and head dim alone
(``route``), never by whether a launch works:

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``), bf16 at hd 64 and
  128 (llama3-8b's prefill and the other dense configs, the embedder's
  width): both products on the tensor cores, K and V staged by TMA, P
  split into two bf16 halves so P.V keeps fp32 weights' precision. Needs
  ``sm_90a`` and the driver's ``cuTensorMapEncodeTiled``; strides a
  multiple of 8 elements and bases 16-byte aligned.
- ``"simt"`` (``csrc/flash_attention.cu``), every fp32 input and bf16 at
  hd 16 and 32: IEEE fp32 products on the SIMT cores, K and V staged by
  ``cp.async`` into a ring; strides and bases aligned to 4 elements. Its
  C dispatch picks the query block by hd (``SIMT_BLOCK_Q``): 128 queries
  at hd 64 and 128, 64 at hd 16 and 32 (twice the blocks where a row's
  work is small).

A launch that fails raises; nothing takes the other kernel or the plain
version instead. Layout: q, k and v keep their (B, S, H, hd) layout and
strides (no permute); a tensor that breaks its route's stride rule is
copied to a contiguous one first, explicitly. The output is a new
contiguous (B, S, H, hd) tensor. A CPU tensor takes the plain version
``ref.flash_attention``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.pairwise_l2 import _cuda_device

# kernel launches by route since the last reset (plain calls excluded);
# ``launches`` reads their total
launches_by_route = {"wgmma": 0, "simt": 0}

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
# each route's stride and base alignment, in elements
_ALIGN = {"wgmma": 8, "simt": 4}
# the SIMT kernel's queries a block, by head dim, as its C dispatch picks
# them (one instantiation each); read by the tests' model of its walk
SIMT_BLOCK_Q = {16: 64, 32: 64, 64: 128, 128: 128}


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel a (dtype, hd) input launches: ``"wgmma"`` for bf16 at hd
    64 or 128, ``"simt"`` for the rest."""
    return ("wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            else "simt")


def __getattr__(name: str):
    if name == "launches":
        return sum(launches_by_route.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    for r in launches_by_route:
        launches_by_route[r] = 0


def _aligned(t: torch.Tensor, elems: int) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (stride 1 in hd,
    every other stride a multiple of ``elems``, the base 16-byte
    aligned), else an explicit contiguous copy."""
    ok = (t.stride(3) == 1 and all(s % elems == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0)
    if ok:
        return t
    return torch.empty(t.shape, dtype=t.dtype,
                       device=t.device).copy_(t)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q, k, v (B, S, H, hd) fp32 or bf16 CUDA tensors of one shape and
    type, hd in ``HEAD_DIMS`` -> (B, S, H, hd) of that type, on the
    kernel ``route(dtype, hd)`` names."""
    return _launch(q, k, v, causal, window, route(q.dtype, q.shape[-1]))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, path: str) -> torch.Tensor:
    """``flash_attention_cuda`` on the ``path`` kernel. Named directly
    only to compare the two kernels at one shape (the SIMT kernel on a
    bf16 hd-128 input); ``"wgmma"`` takes only what ``route`` sends it."""
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
    if path not in _ALIGN or (path == "wgmma"
                              and route(q.dtype, hd) != "wgmma"):
        raise ValueError(f"no {path!r} kernel for {q.dtype} at hd {hd}")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    q, k, v = (_aligned(t, _ALIGN[path]) for t in (q, k, v))
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if path == "wgmma":
        err = build.library("flash_attention_wgmma") \
            .flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, h, hd, int(causal), int(window), scale, *strides, stream)
    else:
        err = build.library("flash_attention").flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, hd, int(q.dtype == torch.bfloat16), int(causal), int(window),
            scale, *strides, stream)
    build.check(err, f"flash_attention ({path})")
    launches_by_route[path] += 1
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
