"""Model zoo on PyTorch: the configs' dense, MoE and VLM-backbone
transformers and the hymba hybrid (counterpart of ``repro/models``)."""
from repro_torch.models.zoo import (  # noqa: F401
    Model, build_model, params_from_numpy, params_to_numpy,
)
