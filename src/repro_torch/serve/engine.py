"""Serving engine: batched prefill + decode, and the embedder that feeds
the platform's vector columns (port of ``repro/serve/engine.py``).

Straggler/fault posture, as in the reference: requests are grouped into
same-length batches (no padding), decode runs a fixed number of steps
per batch, and the engine is stateless between batches.

Port decision (serving types): a model's matrices are held in
``cfg.dtype`` (bf16), cast once when the parameters are made, which is
exactly the cast the reference makes on every use; norm scales stay
fp32 (``models/transformer.py``). ``device=None`` means the CUDA card
and raises without one; on the card the prefill's attention is the
hand-written flash kernel.

``RetrievalServer`` (micro-batched embed -> hybrid query serving) waits
for the serving slice of the platform (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model


@dataclass
class GenRequest:
    prompt: np.ndarray         # (S,) int32
    max_new: int = 16


@dataclass
class GenResult:
    tokens: np.ndarray
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _params(model, params, seed: int):
    if params is None:
        return model.init(seed)
    have, want = params.device, model.device
    if have.type != want.type or (want.index is not None
                                  and have.index != want.index):
        raise ValueError(f"params are on {params.device}, the engine on "
                         f"{model.device}")
    return params


class ServeEngine:
    """Batched greedy generation, exact under mixed prompt lengths.

    Batching contract: ``generate`` buckets requests by PROMPT LENGTH
    and runs each bucket as a padding-free batch (chunked to
    ``batch_size``), then returns results in request order. Bucketing —
    not padding — is what keeps batched generation token-identical to
    per-request generation: ``prefill`` returns logits for the LAST
    position only and every ``KVCache`` carries one ``length``, so a
    right-padded short prompt would take its first greedy token from a
    pad position and decode against pad K/V at wrong positions, and
    left-padding would shift RoPE phases. Within a same-length batch both
    hazards vanish. Batches are sized to the requests present — no
    phantom zero rows padded up to ``batch_size``. (On the card, a
    product's reduction order may depend on the batch's row count, so
    a near tie between the top two logits can resolve differently.)

    ``params``: the model's parameters (``Model.init`` or
    ``params_from_numpy``) on ``device``; None draws them from ``seed``.
    ``prefill_s`` and ``decode_s`` are host-clock seconds of each batch's
    prefill and decode loop, each ending in a device synchronize.
    """

    def __init__(self, cfg: ModelConfig, params=None, *, device=None,
                 max_len: int = 512, batch_size: int = 8, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.params = _params(self.model, params, seed)
        self.max_len = max_len
        self.batch_size = batch_size

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        # mask padded vocab columns before argmax (first maximum wins, as
        # in jnp.argmax)
        v = self.cfg.vocab_size
        lg = logits[..., :v] if logits.shape[-1] > v else logits
        return torch.argmax(lg, dim=-1).to(torch.int32)

    def generate(self, requests: Sequence[GenRequest]) -> List[GenResult]:
        out: List[Optional[GenResult]] = [None] * len(requests)
        by_len: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            by_len.setdefault(len(r.prompt), []).append(i)
        for plen in sorted(by_len):
            idx = by_len[plen]
            for j in range(0, len(idx), self.batch_size):
                sel = idx[j:j + self.batch_size]
                for i, res in zip(sel, self._run_batch(
                        [requests[i] for i in sel])):
                    out[i] = res
        return out  # type: ignore[return-value]

    @torch.no_grad()
    def _run_batch(self, reqs: Sequence[GenRequest]) -> List[GenResult]:
        plen = len(reqs[0].prompt)
        if any(len(r.prompt) != plen for r in reqs):
            raise ValueError("_run_batch requires same-length prompts "
                             "(generate buckets)")
        toks = torch.as_tensor(np.stack([np.asarray(r.prompt, np.int64)
                                         for r in reqs]),
                               device=self.device)
        max_new = max(r.max_new for r in reqs)

        t0 = time.time()
        logits, cache = self.model.prefill(self.params, {"tokens": toks},
                                           self.max_len)
        # the dense family's prefill fills the cache; families whose
        # caches are filled by replaying the prompt through decode
        # (hymba's ring buffer, enc-dec's cross cache) return length 0
        if cache.length == 0:
            for t in range(plen):
                _, cache = self.model.decode(self.params, cache,
                                             toks[:, t:t + 1])
        _sync(self.device)
        prefill_s = time.time() - t0

        t1 = time.time()
        # every row's position -1 is its true last prompt token
        cur = self._greedy(logits[:, -1])[:, None]
        gen = [cur.cpu()]
        for _ in range(max_new - 1):
            logits, cache = self.model.decode(self.params, cache, cur)
            cur = self._greedy(logits[:, -1])[:, None]
            gen.append(cur.cpu())
        decode_s = time.time() - t1
        gen_arr = torch.cat(gen, dim=1).numpy()
        return [GenResult(tokens=gen_arr[i, :reqs[i].max_new],
                          prefill_s=prefill_s, decode_s=decode_s)
                for i in range(len(reqs))]


class EmbeddingServer:
    """Embeds token batches with a pool architecture — feeds the MQRLD
    platform's vector columns. ``embed`` returns (B, d_model) fp32 numpy
    mean-pooled final hidden states."""

    def __init__(self, cfg: ModelConfig, params=None, *, device=None,
                 seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.params = _params(self.model, params, seed)

    def embed(self, tokens: np.ndarray) -> np.ndarray:
        out = self.model.embedding(self.params, {"tokens": tokens})
        return out.cpu().numpy()
