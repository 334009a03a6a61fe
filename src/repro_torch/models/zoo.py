"""Model API over every family (port of ``repro/models/zoo.py``).

``Model = build_model(cfg, device=None, rules=None, mesh=None)`` exposes,
for the dense, MoE, VLM-backbone, hybrid (hymba), SSM (xlstm) and enc-dec
families:
  * ``defs``                        — ParamDef tree (single source of truth)
  * ``init(seed)``                  — random parameters on the device
  * ``abstract()`` / ``specs()``    — the fp32 masters' ``TensorSpec`` tree
                                      and partition specs (``rules``)
  * ``cache_abstract(batch, len)``  — the cache's (abstract, specs)
  * ``input_shardings(shape)``      — the inputs' partition specs
  * ``n_params()``
  * ``forward(params, batch)``      — (logits, MoE aux loss), train-style
                                      dense attention
  * ``embedding(params, batch)``    — pooled features for the MQRLD platform
  * ``prefill(params, batch, len)`` — last-token logits + cache or state
  * ``decode(params, cache, tok)``  — one token
  * ``init_cache(batch, len)``
and, for every family, training:
  * ``init_masters(seed)``          — fp32 masters {reference path:
                                      tensor}, blocks stacked
  * ``loss(params, batch)``         — CE with z-loss + 0.01 x MoE aux
  * ``input_specs(shape)`` / ``make_batch(shape, gen)``
``params`` is the family's parameter module (``transformer.Transformer``,
``hymba.Hymba``, ``xlstm.XLSTM`` or ``encdec.EncDec``) that ``init``
returns or ``params_from_numpy`` loads. A batch holds ``tokens``, with
``patches`` for the VLM and ``frames`` (B, frontend_tokens, d_model) for
enc-dec. ``device=None`` means the CUDA card and raises without one.

Training works on the reference's layout: a flat {path: tensor} dict in
``iter_defs`` order (the reference's flatten order), blocks stacked
((L, ...); hymba's ``win/*`` and xlstm's ``mlstm/*`` (G, W, ...)).
``loss`` takes it in the compute type (the train step's cast of the fp32
masters, the fp32-read leaves rounded to it too, as the reference's
cast rounds them) and reads it through the family's ``stacked_views``,
so gradients come back stacked. ``masters_from_numpy`` /
``masters_to_numpy`` carry fp32 masters to and from the reference's
tree; ``params_from_masters`` makes the serving module of trained
masters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (AUDIO, HYBRID, SSM, ModelConfig,
                                      ShapeConfig)
from repro_torch.models import encdec, hymba, transformer, xlstm
from repro_torch.models import layers as L
from repro_torch.models import spec as S
from repro_torch.sharding.partitioning import P, MeshRules


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_weight: float = 1e-4,
                  valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean CE over all positions, with a small z-loss, in fp32 (fp64
    for fp64 logits). ``valid_vocab`` masks padded vocabulary columns.
    The label's log-prob is a gather (the reference's iota mask sums one
    hit and zeros: the same value)."""
    lg = L.wide(logits)
    if valid_vocab is not None and valid_vocab < lg.shape[-1]:
        mask = torch.arange(lg.shape[-1], device=lg.device) < valid_vocab
        lg = torch.where(mask, lg, torch.full((), -1e30, device=lg.device))
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    ce = torch.mean(lse - ll)
    zl = z_weight * torch.mean(torch.square(lse))
    return ce + zl


# family -> (model module, its parameter module); every other family is
# the transformer's
_FAMILIES = {
    HYBRID: (hymba, hymba.Hymba),
    SSM: (xlstm, xlstm.XLSTM),
    AUDIO: (encdec, encdec.EncDec),
}


def _family(cfg: ModelConfig):
    return _FAMILIES.get(AUDIO if cfg.is_encdec else cfg.family,
                         (transformer, transformer.Transformer))


def _module(cfg: ModelConfig):
    return _family(cfg)[0]


def _params_module(cfg: ModelConfig, flat: Dict[str, torch.Tensor]):
    return _family(cfg)[1](cfg, flat)


def _as_tokens(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).long()


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    # the mesh rules and logical mesh of the dry run's specs; None serves
    # and trains on one card without them
    rules: Optional[MeshRules] = None
    mesh: Any = None

    def __post_init__(self):
        self.mod = _module(self.cfg)
        self.defs = self.mod.model_defs(self.cfg)

    def abstract(self) -> Dict[str, Any]:
        return S.abstract_params(self.defs)

    def specs(self) -> Dict[str, Any]:
        return S.param_specs(self.defs, self._rules())

    def _rules(self) -> MeshRules:
        if self.rules is None:
            raise ValueError(f"{self.cfg.name}: specs need mesh rules: "
                             f"build_model(cfg, rules=...)")
        return self.rules

    def cache_abstract(self, batch: int, max_len: int):
        """(abstract cache or state, its partition specs) in the family's
        cache type."""
        if self.mod is xlstm:
            return xlstm.state_spec(self.cfg, batch, self._rules())
        return self.mod.cache_spec(self.cfg, batch, max_len, self._rules())

    def input_shardings(self, shape: ShapeConfig) -> Dict[str, P]:
        """Each input's spec: the batch axis split over the data axes."""
        r = self._rules()
        return {k: r.spec_for(v.shape, ("batch",) + (None,) * (
            len(v.shape) - 1)) for k, v in self.input_specs(shape).items()}

    def init(self, seed: int = 0):
        flat = S.init_params(
            self.defs, seed, self.device,
            lambda d: transformer.serving_dtype(self.cfg, d))
        return _params_module(self.cfg, flat)

    def init_masters(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """fp32 masters by the init law: the numbers ``init(seed)`` draws,
        before its cast to the serving types."""
        return S.init_params(self.defs, seed, self.device)

    def n_params(self) -> int:
        return S.count_params(self.defs)

    def _inputs(self, batch) -> Dict[str, Any]:
        """The family's inputs by its functions' names: ``tokens``, with
        ``frontend_embeds`` (the VLM's patches) for the transformer and
        ``frames`` for enc-dec."""
        out = {"tokens": _as_tokens(batch["tokens"], self.device)}
        if self.mod is transformer:
            patches = batch.get("patches")
            out["frontend_embeds"] = None if patches is None else \
                torch.as_tensor(patches, device=self.device)
        elif self.mod is encdec:
            if "frames" not in batch:
                raise ValueError(
                    f"{self.cfg.name}: an enc-dec batch needs 'frames' "
                    f"(B, {self.cfg.frontend_tokens}, {self.cfg.d_model}) "
                    f"beside its tokens; train() feeds tokens only "
                    f"(SyntheticLM), so train enc-dec through "
                    f"make_train_step on make_batch's batches")
            out["frames"] = torch.as_tensor(batch["frames"],
                                            device=self.device)
        return out

    @torch.no_grad()
    def forward(self, params, batch, *, mode: str = "train",
                last_only: bool = False):
        return self.mod.forward(self.cfg, params, **self._inputs(batch),
                                mode=mode, last_only=last_only)

    def loss(self, params, batch) -> torch.Tensor:
        """The train objective: ``cross_entropy`` over the text positions
        (the VLM's logits cover its patches too) plus 0.01 x the MoE aux
        loss. ``params``: {reference path: tensor}, blocks stacked, in the
        compute type; gradients flow to those tensors. Runs the family's
        forward in train mode on its ``stacked_views`` (with block or
        group remat where the config asks for it)."""
        b = self._inputs(batch)
        views = self.mod.stacked_views(self.cfg, params)
        logits, aux = self.mod.forward(self.cfg, views, **b, mode="train")
        labels = _as_tokens(batch["labels"], self.device)
        if self.cfg.frontend == "vit_stub":
            logits = logits[:, batch["patches"].shape[1]:]
        return cross_entropy(logits, labels,
                             valid_vocab=self.cfg.vocab_size) + 0.01 * aux

    def input_specs(self, shape: ShapeConfig) -> Dict[str, S.TensorSpec]:
        """Shape and type of every model input of a shape cell."""
        cfg = self.cfg
        b = shape.global_batch
        i32 = torch.int32
        dt = transformer.torch_dtype(cfg.dtype)
        spec = S.TensorSpec
        if shape.kind == "decode":
            return {"tokens": spec((b, 1), i32)}
        s = shape.seq_len
        out: Dict[str, S.TensorSpec] = {}
        if cfg.is_encdec:
            out["frames"] = spec((b, cfg.frontend_tokens, cfg.d_model), dt)
        elif cfg.frontend == "vit_stub":
            s -= cfg.frontend_tokens
            out["patches"] = spec((b, cfg.frontend_tokens, cfg.d_model), dt)
        out["tokens"] = spec((b, s), i32)
        if shape.kind == "train":
            out["labels"] = spec((b, s), i32)
        return out

    def make_batch(self, shape: ShapeConfig, seed: int = 0
                   ) -> Dict[str, torch.Tensor]:
        """A random batch matching ``input_specs`` on the model's device:
        integers uniform in [0, vocab_size), the rest standard normal,
        drawn in turn from one ``torch.Generator`` seeded with ``seed``
        (the reference's shapes, types and ranges, not its numbers)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        out = {}
        for name, sp in self.input_specs(shape).items():
            if sp.dtype == torch.int32:
                out[name] = torch.randint(
                    0, self.cfg.vocab_size, sp.shape, generator=gen,
                    device=self.device, dtype=sp.dtype)
            else:
                out[name] = torch.randn(sp.shape, generator=gen,
                                        device=self.device).to(sp.dtype)
        return out

    @torch.no_grad()
    def embedding(self, params, batch) -> torch.Tensor:
        """Mean-pooled final hidden state — the platform's feature vector
        (for enc-dec, the pooled encoder states)."""
        b = self._inputs(batch)
        if self.mod is transformer:
            return transformer.pooled_embedding(self.cfg, params, **b)
        return self.mod.forward(self.cfg, params, **b, return_hidden=True)

    @torch.no_grad()
    def prefill(self, params, batch, max_len: int):
        """Consume the prompt; return (last logits, cache). The
        transformer fills a KV cache and xlstm its recurrent state
        (length = the prompt's). hymba and enc-dec run a stream forward
        for the logits and return a cache of length 0 (enc-dec's holding
        its cross-attention K/V), which ``ServeEngine`` fills by
        replaying the prompt through ``decode``, as the reference's
        does."""
        b = self._inputs(batch)
        tokens = b["tokens"]
        bsz = tokens.shape[0]
        if self.mod is xlstm:
            return xlstm.prefill(self.cfg, params, tokens,
                                 self.init_cache(bsz, max_len))
        if self.mod is hymba:
            lg, _ = hymba.forward(self.cfg, params, tokens, mode="stream",
                                  last_only=True)
            return lg, self.init_cache(bsz, max_len)
        if self.mod is encdec:
            lg, _ = encdec.forward(self.cfg, params, tokens, b["frames"],
                                   mode="stream", last_only=True)
            return lg, encdec.build_cross_cache(
                self.cfg, params, b["frames"], self.init_cache(bsz, max_len))
        return transformer.prefill(self.cfg, params, tokens, max_len,
                                   frontend_embeds=b["frontend_embeds"])

    @torch.no_grad()
    def decode(self, params, cache, tokens):
        return self.mod.decode_step(self.cfg, params, cache,
                                    _as_tokens(tokens, self.device))

    def init_cache(self, batch: int, max_len: int):
        if self.mod is xlstm:
            return xlstm.init_state(self.cfg, batch, self.device)
        return self.mod.init_cache(self.cfg, batch, max_len, self.device)


def build_model(cfg: ModelConfig, device=None, *,
                rules: Optional[MeshRules] = None, mesh=None) -> Model:
    """The model of ``cfg`` on ``device`` (None: the card, raising without
    one). ``device`` comes second, before the reference's ``rules`` and
    ``mesh``, which only the dry run's specs read."""
    return Model(cfg=cfg, device=resolve_device(device), rules=rules,
                 mesh=mesh)


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """Carry a parameter tree in the reference's layout (nested dicts of
    numpy arrays, blocks stacked (L, ...), hymba's ``win/*`` and xlstm's
    ``mlstm/*`` (G, W, ...), as ``Model.init`` returns it in ``repro``)
    into the port's modules on ``device``, each tensor in its serving
    type. Reference path
    ``blocks/attn/wq`` becomes ``blocks.i.attn.wq`` for each layer i
    (``transformer.port_name``); every path of the family's
    ``model_defs(cfg)`` must be present, and no other."""
    return _params_module(cfg, _from_tree(
        cfg, tree, device, lambda d: transformer.serving_dtype(cfg, d)))


def masters_from_numpy(cfg: ModelConfig, tree, device=None
                       ) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (as ``params_from_numpy`` takes it)
    as fp32 training masters on ``device``: {reference path: tensor} in
    ``iter_defs`` order, blocks stacked."""
    return _from_tree(cfg, tree, device, lambda d: torch.float32)


def _from_tree(cfg: ModelConfig, tree, device, dtype_of
               ) -> Dict[str, torch.Tensor]:
    """{path: tensor} of every def's leaf of ``tree``, each in
    ``dtype_of(def)`` on ``device``."""
    dev = resolve_device(device)
    defs = dict(S.iter_defs(_module(cfg).model_defs(cfg)))
    flat = {}
    for path, d in defs.items():
        try:
            arr = S.tree_get(tree, path)
        except (KeyError, TypeError):
            raise ValueError(f"{cfg.name}: the tree has no {path!r}") \
                from None
        arr = np.array(arr, np.float32)
        if arr.shape != d.shape:
            raise ValueError(f"{path}: shape {arr.shape} != {d.shape}")
        flat[path] = torch.from_numpy(arr).to(device=dev, dtype=dtype_of(d))
    extra = {p for p, _ in _leaves(tree)} - set(defs)
    if extra:
        raise ValueError(f"{cfg.name}: paths not in the model: "
                         f"{sorted(extra)}")
    return flat


def masters_to_numpy(masters: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """fp32 masters as the reference's nested tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for path, t in masters.items():
        S.tree_set(tree, path, t.detach().float().cpu().numpy())
    return tree


def params_from_masters(cfg: ModelConfig, masters: Dict[str, torch.Tensor]):
    """The family's parameter module of (trained) masters, each tensor
    cast to its serving type on the masters' device."""
    defs = dict(S.iter_defs(_module(cfg).model_defs(cfg)))
    return _params_module(cfg, {
        path: masters[path].detach().to(transformer.serving_dtype(cfg, d))
        for path, d in defs.items()})


def params_to_numpy(cfg: ModelConfig, params) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: the reference's tree, as
    fp32 numpy arrays (exact for bf16 parameters), layers stacked."""
    state = dict(params.named_parameters())
    tree: Dict[str, Any] = {}
    for path, d in S.iter_defs(_module(cfg).model_defs(cfg)):
        lead = d.shape[:S.n_stacked(d)]
        t = torch.stack([state[transformer.port_name(path, *i)]
                         for i in np.ndindex(*lead)]).reshape(d.shape) \
            if lead else state[transformer.port_name(path)]
        S.tree_set(tree, path, t.detach().float().cpu().numpy())
    return tree


def _leaves(tree, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, val
