"""The paper's own workload: a compact retrieval-embedding backbone.

MQRLD itself is architecture-agnostic (its pool in the paper is CLIP-family);
this config is the ~100M-parameter text embedder used by the end-to-end
example (train a few hundred steps, then feed the platform).
"""
from repro_torch.configs.base import ModelConfig, DENSE, register

CONFIG = register(ModelConfig(
    name="mqrld-embedder-100m",
    family=DENSE,
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=32768,
    rope_theta=10_000.0,
))
