"""Model zoo on PyTorch: configs' dense and VLM-backbone transformers
(counterpart of ``repro/models``)."""
from repro_torch.models.zoo import (  # noqa: F401
    Model, build_model, params_from_numpy, params_to_numpy,
)
