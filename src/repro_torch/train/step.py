"""Train and serve steps (port of ``repro/train/step.py``).

``make_train_step`` builds the full update: cast the fp32 masters to the
compute type, split the batch into microbatches, take each one's
gradient and sum them in fp32, then the global-norm clip and AdamW on
the masters (``train/optimizer.py``).

The cast covers every floating parameter, norm scales included, as the
reference's ``_cast_tree`` does: training computes in ``cfg.dtype``
throughout (the serving modules keep vectors in fp32 instead). Each
microbatch's gradient is taken with ``torch.autograd.grad`` and added to
an fp32 sum, so autograd never accumulates a bf16 ``.grad`` across
microbatches.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import counted
from repro_torch.configs.base import TrainConfig
from repro_torch.models.transformer import torch_dtype
from repro_torch.train.optimizer import AdamState, adam_update
from repro_torch.utils.quant import div


@counted
def split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """The batch as ``n`` microbatches of consecutive rows (the
    reference's ``reshape((n, b // n) + ...)``)."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not "
                             f"split into {n} microbatches")
    return [{k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))[i]
             for k, x in batch.items()} for i in range(n)]


def _on(model, batch) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=model.device)
            for k, v in batch.items()}


def loss_and_grads(model, params: Dict[str, torch.Tensor], batch,
                   microbatches: int = 1):
    """(loss, grads) of one step's batch: the masters cast to the compute
    type, one gradient per microbatch summed in fp32, the mean over the
    microbatches; loss fp32 (fp64 for an fp64 model), grads {path: fp32
    tensor} (fp64 for an fp64 model)."""
    compute = torch_dtype(model.cfg.dtype)
    acc_dtype = torch.float64 if compute == torch.float64 else torch.float32
    batch = _on(model, batch)
    p_c = {k: t.detach().to(compute).requires_grad_(True)
           for k, t in params.items()}
    leaves = list(p_c.values())

    def grads_of(mb):
        loss = model.loss(p_c, mb)
        return loss.detach(), torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)

    if microbatches > 1:
        acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
               for p in params.values()]
        loss = torch.zeros((), dtype=acc_dtype, device=model.device)
        for mb in split_microbatches(batch, microbatches):
            l, g = grads_of(mb)
            for a, gi in zip(acc, g):
                a.add_(gi.to(acc_dtype))
            loss = loss + l
        return div(loss, microbatches), dict(zip(params, (
            div(a, microbatches) for a in acc)))
    loss, g = grads_of(batch)
    return loss, dict(zip(params, (gi.to(acc_dtype) for gi in g)))


def make_train_step(model, tc: TrainConfig, state_dtype: str = "float32"):
    """Returns train_step(params, opt, batch) -> (params, opt, metrics):
    ``params`` fp32 masters {path: tensor}, ``batch`` arrays or tensors,
    metrics ``loss`` (fp32), ``grad_norm`` and ``step`` (the new count).
    The inputs are left as they were."""

    def train_step(params: Dict[str, torch.Tensor], opt: AdamState, batch):
        loss, grads = loss_and_grads(model, params, batch, tc.microbatches)
        new_p, new_opt, gnorm = adam_update(tc, params, grads, opt,
                                            state_dtype)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "step": new_opt.count}
        return new_p, new_opt, metrics

    return train_step


def make_eval_step(model):
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(params, _on(model, batch))
    return eval_step


def make_prefill_step(model, max_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)
    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, tokens):
        return model.decode(params, cache, tokens)
    return decode_step
