"""AdamW on fp32 masters with fp32, bf16 or int8 state (port of
``repro/train/optimizer.py``).

The parameters are a flat {reference path: fp32 tensor} dict in the
reference's flatten order, blocks stacked (L, ...) as the reference
stacks them. The stacking matters: weight decay applies where the
parameter has rank >= 2, and int8 codes are kept where the state tensor
has rank >= 2, both judged on the stacked shape, so a block's norm scale
(L, d) is decayed and int8-coded while ``norm_f`` (d,) is not.

int8 state is per-channel (last axis) symmetric codes of the tensor's
own shape with fp32 scales ``shape[:-1] + (1,)`` (``utils/quant.py``);
the second moment is stored as codes of sqrt(v), and a code-0 entry's
denominator is floored at half a quantization step (``_decode_v``).

Numerics follow the reference's: the step count is an int32 tensor, the
bias corrections ``1 - b ** count`` and the learning-rate schedule are
fp32 tensor arithmetic (computed on the host, where the count lives, and
used as the fp32 values they are), the global-norm clip sums the squares
of every gradient in fp32, and each elementwise line is the reference's
expression in its order, each division and square root rounded once
(``utils/quant.div``, ``sqrt_rn``: torch's vectorized CPU ``sqrt``,
and its CUDA division by a Python scalar, can land an ulp off), so an
update on the card equals the CPU's bit for bit given the same global
norm. The update returns new tensors and leaves its
inputs as they were, which is what lets the loop keep the last good
state when a step is poisoned.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import counted
from repro_torch.configs.base import TrainConfig
from repro_torch.models.spec import TensorSpec
from repro_torch.models.transformer import torch_dtype
from repro_torch.sharding.partitioning import P
from repro_torch.utils.quant import dequantize_i8, div, quantize_i8, sqrt_rn

STATE_DTYPES = ("float32", "bfloat16", "int8")


def _quantizable(shape) -> bool:
    return len(shape) >= 2


@dataclass
class AdamState:
    m: Dict[str, Any]      # {path: tensor, or (int8 codes, fp32 scales)}
    v: Dict[str, Any]
    count: torch.Tensor    # int32, 0-d, on the host


def _encode(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        if not _quantizable(x.shape):
            return x  # tiny 0/1-d tensors stay fp32
        return quantize_i8(x)
    return x.to(torch_dtype(dtype))


def _decode(enc, dtype: str) -> torch.Tensor:
    if dtype == "int8" and isinstance(enc, tuple):
        return dequantize_i8(enc[0], enc[1])
    return enc.float()


def _encode_v(v: torch.Tensor, dtype: str):
    """Second-moment encode. int8 codes store sqrt(v) (the RMS): linear
    codes on v itself underflow to 0 for any entry 254x below its channel
    max, and a zero denominator under a nonzero first moment turns one
    Adam step into mh/eps. RMS codes halve the dynamic range in log
    space, and the decode side clamps the denominator at the remaining
    quantization resolution."""
    if dtype == "int8":
        if not _quantizable(v.shape):
            return v
        return quantize_i8(sqrt_rn(v))
    return v.to(torch_dtype(dtype))


def _decode_v(enc, dtype: str):
    """Returns (v fp32, denominator floor or None). The floor is half a
    quantization step of sqrt(v): a code-0 entry may hide a true RMS up
    to this value, so the Adam denominator never drops below it."""
    if dtype == "int8" and isinstance(enc, tuple):
        s = dequantize_i8(enc[0], enc[1])
        return torch.square(s), 0.5 * enc[1]
    return enc.float(), None


def _check_dtype(state_dtype: str) -> None:
    if state_dtype not in STATE_DTYPES:
        raise ValueError(f"state_dtype {state_dtype!r} is not one of "
                         f"{STATE_DTYPES}")


def init_adam(params: Dict[str, torch.Tensor],
              state_dtype: str = "float32") -> AdamState:
    _check_dtype(state_dtype)
    m = {k: _encode(torch.zeros(p.shape, device=p.device), state_dtype)
         for k, p in params.items()}
    v = {k: _encode_v(torch.zeros(p.shape, device=p.device), state_dtype)
         for k, p in params.items()}
    return AdamState(m=m, v=v, count=torch.zeros((), dtype=torch.int32))


def adam_abstract(params_abs: Dict[str, Any],
                  state_dtype: str = "float32") -> AdamState:
    """The state's shapes and types without storage; ``params_abs``:
    {path: anything with a ``shape``} (``TensorSpec``, ``ParamDef``, a
    tensor)."""
    _check_dtype(state_dtype)

    def z(p):
        shape = tuple(p.shape)
        if state_dtype == "int8":
            if not _quantizable(shape):
                return TensorSpec(shape, torch.float32)
            return (TensorSpec(shape, torch.int8),
                    TensorSpec(shape[:-1] + (1,), torch.float32))
        return TensorSpec(shape, torch_dtype(state_dtype))
    return AdamState(m={k: z(p) for k, p in params_abs.items()},
                     v={k: z(p) for k, p in params_abs.items()},
                     count=TensorSpec((), torch.int32))


def adam_specs(params_abs: Dict[str, Any], param_specs: Dict[str, Any],
               rules=None, state_dtype: str = "float32") -> AdamState:
    """The state's partition specs, mirroring the parameters': {path:
    spec} for m and v (int8: (the codes' spec, the scales' with their
    last axis unsplit) where the codes are kept), and ``P()`` for the
    count. ``params_abs`` and ``param_specs`` are keyed alike."""
    _check_dtype(state_dtype)

    def sp(p, s):
        if state_dtype == "int8" and _quantizable(tuple(p.shape)):
            return (s, P(*(tuple(s)[:-1] + (None,))))
        return s
    leaves = {k: sp(p, param_specs[k]) for k, p in params_abs.items()}
    return AdamState(m=dict(leaves), v=dict(leaves), count=P())


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine to a tenth; ``step`` an fp32 tensor,
    every operation in fp32 as the reference's."""
    warm = torch.clamp_max(step / max(tc.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


@counted
def _scalars(tc: TrainConfig, count: torch.Tensor) -> Tuple[float, ...]:
    """(c1, c2, lr) at ``count`` as fp32 tensors on the host, returned as
    the Python floats that hold those fp32 values exactly (an fp32
    operand of every elementwise line on any device)."""
    cf = count.cpu().float()
    c1 = 1 - tc.beta1 ** cf
    c2 = 1 - tc.beta2 ** cf
    return c1.item(), c2.item(), lr_schedule(tc, cf).item()


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the fp32 sum over every leaf of its fp32 sum of squares."""
    gsq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
    return sqrt_rn(gsq)


def adam_update(tc: TrainConfig, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: AdamState,
                state_dtype: str = "float32", gnorm=None):
    """One AdamW step: (new params, new state, global grad norm). params
    fp32 masters, grads fp32, both {path: tensor} in the same order; the
    inputs are not modified. ``gnorm``: the global gradient norm to clip
    by, ``global_norm(grads)`` when None (a check that holds one device's
    update to another's passes the first one's, since the two sums of
    squares add in different orders)."""
    _check_dtype(state_dtype)
    count = state.count + 1
    b1, b2 = tc.beta1, tc.beta2
    c1, c2, lr = _scalars(tc, count)

    # global-norm clip
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp_max(tc.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)

    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * clip
        m = _decode(state.m[k], state_dtype)
        v, vfloor = _decode_v(state.v[k], state_dtype)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh, vh = div(m, c1), div(v, c2)
        den = sqrt_rn(vh)
        if vfloor is not None:
            den = torch.maximum(den, vfloor)
        step_ = mh / (den + tc.eps)
        decay = tc.weight_decay * (p.dim() >= 2)
        new_p[k] = p - lr * (step_ + decay * p)
        new_m[k] = _encode(m, state_dtype)
        new_v[k] = _encode_v(v, state_dtype)
    return new_p, AdamState(m=new_m, v=new_v, count=count), gnorm


# ---------------------------------------------------------------------------
# The reference's state carried across
# ---------------------------------------------------------------------------
def _leaves(tree, prefix: str = ""):
    """(path, leaf) of a nested dict, dict keys sorted (the reference's
    flatten order); a (codes, scale) tuple is one leaf."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, val


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 as ml_dtypes gives it) as a tensor of its
    type."""
    if str(getattr(a, "dtype", "")) == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def state_from_numpy(m, v, count, device=None) -> AdamState:
    """The reference's ``AdamState`` fields (nested dicts of numpy
    arrays, an int8 leaf a (codes, scales) tuple; ``count`` a scalar)
    as the port's, the moments on ``device`` in their stored types."""
    from repro_torch import resolve_device
    dev = resolve_device(device)

    def conv(tree):
        return {path: tuple(_tensor(a, dev) for a in leaf)
                if isinstance(leaf, tuple) else _tensor(leaf, dev)
                for path, leaf in _leaves(tree)}
    return AdamState(m=conv(m), v=conv(v),
                     count=torch.tensor(int(np.asarray(count)),
                                        dtype=torch.int32))


def state_to_numpy(state: AdamState) -> Dict[str, Any]:
    """{"m": tree, "v": tree, "count": int32}: the state as nested dicts
    of numpy arrays in the reference's layout (bf16 moments as fp32
    arrays of the same values; numpy has no bf16)."""
    from repro_torch.models.spec import tree_set

    def conv(flat):
        tree: Dict[str, Any] = {}
        for path, leaf in flat.items():
            tree_set(tree, path, tuple(_numpy(t) for t in leaf)
                     if isinstance(leaf, tuple) else _numpy(leaf))
        return tree
    return {"m": conv(state.m), "v": conv(state.v),
            "count": np.int32(int(state.count))}


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
