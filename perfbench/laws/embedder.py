"""Operations of the embedder's forward for a batch of B prompts of S
tokens: what the model needs, whatever a run computes. Per layer and
token: the q, k, v and output projections (2 x 4 d^2), the SwiGLU MLP
(2 x 3 d f); per layer and causal pair of positions (S (S + 1) / 2 per
prompt): the score and the weighted sum of V (2 x 2 d). The pooled
embedding reads no unembedding."""
from __future__ import annotations


def forward_flops(model: dict, b: int, s: int) -> float:
    d, f, n = model["d_model"], model["d_ff"], model["num_layers"]
    per_token = 8.0 * d * d + 6.0 * d * f
    pairs = s * (s + 1) / 2.0
    return n * b * (s * per_token + pairs * 4.0 * d)
