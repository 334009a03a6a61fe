"""Parameter declaration (port of ``repro/models/spec.py``).

Each model declares its parameters once as a nested dict of ``ParamDef``
(shape, logical axes, init law). ``init_params`` draws them; the model
modules then hold them under the same names. ``TensorSpec`` stands in for
the reference's ``jax.ShapeDtypeStruct`` (shapes and types, no storage):
``abstract_params`` gives the fp32 masters' tree of them, and
``param_specs`` each parameter's partition spec under a ``MeshRules``,
both keyed as the defs are (what the dry run, ``launch/dryrun.py``,
reads).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch


@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and type, without storage."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"       # "normal" | "zeros" | "ones"
    scale: float = 1.0          # stddev multiplier for "normal"
    # the type the reference reads the parameter in: None for the
    # compute type (``p.astype(x.dtype)``), "float32" where it reads
    # ``p.astype(jnp.float32)`` whatever the compute type
    read_as: Optional[str] = None

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map_defs(fn: Callable[[ParamDef], Any], defs) -> Dict[str, Any]:
    """``fn`` of every ParamDef of a nested dict, in a dict of the same
    keys."""
    return {k: fn(v) if is_def(v) else tree_map_defs(fn, v)
            for k, v in defs.items()}


def abstract_params(defs) -> Dict[str, Any]:
    """The parameters' shapes and types without storage: fp32, the
    masters' type (the reference's ``ParamDef.dtype``, which no model
    sets otherwise)."""
    return tree_map_defs(lambda d: TensorSpec(d.shape, torch.float32), defs)


def param_specs(defs, rules) -> Dict[str, Any]:
    """Each parameter's partition spec: ``rules.spec_for`` of its shape
    and logical axes."""
    return tree_map_defs(lambda d: rules.spec_for(d.shape, d.logical), defs)


def iter_defs(defs, prefix: str = "") -> Iterator[Tuple[str, ParamDef]]:
    """(path, ParamDef) leaves in the reference's flatten order (dict keys
    sorted, as ``jax.tree.flatten`` orders them); paths join keys with
    '/', as in ``blocks/attn/wq``."""
    for key in sorted(defs):
        val = defs[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, ParamDef):
            yield path, val
        else:
            yield from iter_defs(val, path)


def init_params(defs, seed: int, device, dtype_of: Optional[Callable[
        [ParamDef], torch.dtype]] = None) -> Dict[str, torch.Tensor]:
    """Draw every parameter: {path: tensor}. The reference's law, on the
    declared (for blocks, stacked (L, ...)) shape: "normal" is
    N(0, 1) * scale / sqrt(shape[-2]) (shape[-1] for a vector), "zeros"
    and "ones" are constant. One ``torch.Generator`` on ``device``,
    seeded from ``seed``, draws the leaves in flatten order; a stacked
    leaf is drawn one layer at a time. Each tensor is made in fp32 and,
    when ``dtype_of(def)`` names another type, cast as soon as it
    is made, so the fp32 copy of one layer is all that is ever extra.
    (The reference splits a JAX key per leaf: the same law, other
    numbers.)"""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for path, d in iter_defs(defs):
        dt = dtype_of(d) if dtype_of is not None else torch.float32
        if d.init in ("zeros", "ones"):
            fill = 0.0 if d.init == "zeros" else 1.0
            out[path] = torch.full(d.shape, fill, dtype=dt, device=device)
            continue
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(1, fan_in))
        t = torch.empty(d.shape, dtype=dt, device=device)
        layers = t if d.logical[0] == "layers" else t[None]
        for piece in layers:
            piece.copy_(torch.randn(piece.shape, generator=gen,
                                    device=device).mul_(std))
        out[path] = t
    return out


def n_stacked(d: ParamDef) -> int:
    """How many leading axes stack layers (``stack_defs``): 1 for a
    transformer's blocks, 2 for hymba's windowed (groups, places)."""
    n = 0
    while n < len(d.logical) and d.logical[n] == "layers":
        n += 1
    return n


def count_params(defs) -> int:
    return sum(int(math.prod(d.shape)) for _, d in iter_defs(defs))


def tree_get(tree, path: str) -> Any:
    """The leaf at ``a/b/c`` of a nested dict."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


def tree_set(tree: Dict[str, Any], path: str, value: Any) -> None:
    keys = path.split("/")
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value
