"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

12L (enc) + 12L (dec) d_model=1024 16H (MHA) d_ff=4096 vocab=256206. The audio
frontend is a stub: ``input_specs()`` feeds precomputed frame embeddings to the
encoder; the decoder is a text LM with cross-attention.
"""
from repro_torch.configs.base import ModelConfig, AUDIO, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family=AUDIO,
    num_layers=12,           # decoder layers
    enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio_stub",
    frontend_tokens=4096,    # precomputed audio frame embeddings (encoder side)
    rope_theta=10_000.0,
))
