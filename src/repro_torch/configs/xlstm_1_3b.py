"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H d_ff=0 vocab=50304. d_ff=0: xLSTM blocks carry their own
up/down projections. Every 8th block is an sLSTM block (sequential recurrence);
the rest are mLSTM (matrix-memory, chunked-parallel trainable, O(1) decode).
"""
from repro_torch.configs.base import ModelConfig, SSM, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family=SSM,
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    mlstm_chunk=64,
))
