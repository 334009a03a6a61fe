"""A text-search table: unit-norm rows around topic vectors. Each topic
is a seeded prompt of ``prompt_len`` tokens; its vector is the unit
embedding of that prompt by the reference's fp32 forward of the
configuration's embedder on the benchmark's weights. A row is
unit(t + ``spread`` g / sqrt(dim)), t its topic's vector (topics drawn
uniformly), g ~ N(0, I). Numeric column ``id``: a seeded permutation of
0..rows-1, independent of the vectors, as a load order would be."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import embedder as ref_embedder


def make(config: dict, seed: int, device, world: dict) -> dict:
    t, model = config["table"], config["embedder"]
    rows, dim = int(config["rows"]), int(config["dim"])
    if dim != model["d_model"]:
        raise ValueError("rows are embeddings: dim must be d_model")
    prompts = inputs.topic_prompts(seed, t["topics"], t["prompt_len"],
                                   model["vocab_size"])
    wf = {k: v.float() for k, v in world["weights"].items()}
    ref_embedder.ieee_fp32()
    e = ref_embedder.pooled(wf, torch.as_tensor(prompts, device=device),
                            model)
    del wf
    topics = e / e.norm(dim=1, keepdim=True)
    gen = inputs.generator(seed, device, 11)
    cat = torch.randint(0, t["topics"], (rows,), generator=gen,
                        device=device)
    vec = topics[cat] + torch.randn((rows, dim), generator=gen,
                                    device=device) * (t["spread"] / dim ** 0.5)
    vec /= vec.norm(dim=1, keepdim=True)
    ids = inputs.rng(seed, 12).permutation(rows).astype(np.float32)
    world["topic_prompts"] = prompts
    return {"vector": {t["column"]: vec.cpu().numpy()},
            "numeric": {t["id_column"]: ids}}
