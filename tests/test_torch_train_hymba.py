"""Training the hymba family in the port against the JAX package on the
CPU: ``Model.loss`` and every gradient leaf against the reference's
``jax.value_and_grad(Model.loss)`` on reduced hymba-1.5b (2 layers: one
windowed and one global block, each with its attention and Mamba
branches), its window cut to 4 positions so that it binds at 16 tokens.
fp32 at the init law and with q and k tempered, bf16 at the init law
against the reference run op by op. Helpers, configs and tolerances:
``test_torch_train_families.py``.
"""
import pytest
import torch

from test_torch_train_families import hold_family

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_loss_and_grads_match_reference(dtype):
    hold_family("hymba-1.5b", fp32_laws=("init", "tempered"), dtype=dtype)
