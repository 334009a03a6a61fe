"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2, with a
parallel dense residual MLP per layer (Arctic's dense-MoE hybrid).
"""
from repro_torch.configs.base import ModelConfig, MOE, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family=MOE,
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=0,
    vocab_size=32000,
    num_experts=128,
    top_k=2,
    moe_ff=4864,
    dense_residual_ff=7168,  # parallel dense residual branch
    rope_theta=10_000.0,
))
