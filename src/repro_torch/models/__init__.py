"""Model zoo on PyTorch: the configs' dense, MoE and VLM-backbone
transformers, the hymba hybrid, xLSTM and the encoder-decoder
(counterpart of ``repro/models``)."""
from repro_torch.models.zoo import (  # noqa: F401
    Model, build_model, cross_entropy, masters_from_numpy, masters_to_numpy,
    params_from_masters, params_from_numpy, params_to_numpy,
)
