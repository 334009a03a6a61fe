"""Model zoo on PyTorch: the configs' dense, MoE and VLM-backbone
transformers, the hymba hybrid, xLSTM and the encoder-decoder
(counterpart of ``repro/models``)."""
from repro_torch.models.zoo import (  # noqa: F401
    Model, build_model, params_from_numpy, params_to_numpy,
)
