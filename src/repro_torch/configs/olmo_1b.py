"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838; hf].

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig, DENSE, register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    family=DENSE,
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_ln",
    rope_theta=10_000.0,
))
