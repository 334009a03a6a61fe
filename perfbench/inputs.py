"""Inputs the benchmark makes from ``--seed`` and hands to both the program
and the plain reference: random streams, the embedder's weights and the
token prompts. Nothing here imports the program."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def seed_state(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream, derived from ``--seed`` and a tag per
    use (any whole numbers), so streams of one run never share numbers."""
    ss = np.random.SeedSequence([2 * abs(int(t)) + (t < 0)
                                 for t in (seed, *tags)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(seed_state(seed, *tags))


def generator(seed: int, device, *tags: int) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed_state(seed, *tags))
    return gen


def embedder_weights(model: dict, seed: int,
                     device) -> Dict[str, torch.Tensor]:
    """The embedder's weights in their logical (unpadded) layout and in the
    types they are served in: matrices in bf16, norm scales in fp32. The
    law (listed under ``assumed`` in the configuration): every matrix
    N(0, 1 / fan_in), with fan_in the number of inputs each output sums
    over; the token table N(0, 1); norm scales 1 + 0.1 N(0, 1). Each leaf
    is drawn for all layers at once by one generator on ``device``."""
    if model["num_kv_heads"] != model["num_heads"]:
        raise ValueError("the weight law draws one kv head per query head")
    gen = generator(seed, device, 1)
    n, d, h = model["num_layers"], model["d_model"], model["num_heads"]
    hd, f, v = d // h, model["d_ff"], model["vocab_size"]
    bf16 = torch.bfloat16

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=device)
        return t.mul_(1.0 / math.sqrt(fan_in)).to(bf16)

    def scale(shape):
        return torch.randn(shape, generator=gen, device=device).mul_(0.1) \
            .add_(1.0)

    return {
        "tok": normal((v, d), 1),
        "wq": normal((n, d, h, hd), d),
        "wk": normal((n, d, h, hd), d),
        "wv": normal((n, d, h, hd), d),
        "wo": normal((n, h, hd, d), h * hd),
        "w_gate": normal((n, d, f), d),
        "w_up": normal((n, d, f), d),
        "w_down": normal((n, f, d), f),
        "norm1": scale((n, d)),
        "norm2": scale((n, d)),
        "norm_f": scale((d,)),
    }


def topic_prompts(seed: int, topics: int, length: int, vocab: int
                  ) -> np.ndarray:
    """(topics, length) int32 token prompts, one per topic."""
    return rng(seed, 2).integers(0, vocab, (topics, length)).astype(np.int32)
