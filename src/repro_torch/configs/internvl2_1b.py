"""internvl2-1b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The ViT frontend is a
stub per the assignment: ``input_specs()`` provides precomputed patch
embeddings that are prepended to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig, VLM, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family=VLM,
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1_000_000.0,
    frontend="vit_stub",
    frontend_tokens=256,  # precomputed ViT patch embeddings per image
))
