"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16. Each block
runs attention heads and Mamba (selective SSM) heads in parallel on the same
input and fuses (averages) their normalized outputs. Sliding-window attention
(1024) on most layers with full attention every 8th layer keeps 512k decode
sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, HYBRID, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family=HYBRID,
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_heads=25,
    window=1024,
    global_every=8,
    rope_theta=10_000.0,
))
