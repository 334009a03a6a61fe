"""Training the enc-dec family in the port against the JAX package on
the CPU (reduced seamless-m4t-medium: 2 + 2 layers, 8 Gaussian frames):
``Model.loss`` and every gradient leaf against the reference's
``jax.value_and_grad(Model.loss)``; remat in all three new families;
and ``train()``, which feeds tokens only, refusing enc-dec with its
reason. Helpers, configs and tolerances: ``test_torch_train_families.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_train_families import (EXACT_TOL, _close, batch_for,
                                       exact_grads, hold_family,
                                       port_value_and_grad,
                                       ref_value_and_grad)
from repro_torch.configs import TrainConfig, get_config
from repro_torch.models import build_model
from repro_torch.models import encdec as TE
from repro_torch.models import hymba as TH
from repro_torch.models import xlstm as TX
from repro_torch.train import loop as tloop

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_loss_and_grads_match_reference(dtype):
    """Reduced enc-dec with Gaussian frames: tempered in fp32 (with the
    init law held to the exact gradient), the init law in bf16."""
    tm, jm, masters, batch, jitted = hold_family(
        "seamless-m4t-medium", fp32_laws=("tempered",), dtype=dtype)
    if dtype != "float32":
        return
    # at the init law each package within EXACT_TOL of the exact gradient
    _, g64 = exact_grads(tm.cfg, masters, batch)
    _, grads = port_value_and_grad(tm, masters, batch)
    _, jg = ref_value_and_grad(jm, masters, batch, dtype, jitted)
    for k, want in g64.items():
        _close(grads[k], want.numpy(), EXACT_TOL, ("port", k))
        _close(jg[k], want.numpy(), EXACT_TOL, ("reference", k))




REMAT = {"xlstm-1.3b": (TX, dict(num_layers=4, slstm_every=2), 2),
         "hymba-1.5b": (TH, dict(num_layers=4), 2),
         "seamless-m4t-medium": (TE, {}, 4)}


@pytest.mark.parametrize("name", sorted(REMAT))
def test_remat_changes_memory_not_values(name, monkeypatch):
    """``remat="block"`` recomputes the reference's blocks (xlstm: each
    mLSTM block, not the sLSTM; hymba: each windowed block, not the
    global; enc-dec: every encoder and decoder block) through
    ``torch.utils.checkpoint``: the loss and every gradient bit for bit
    those of ``remat="none"``, fewer bytes saved for the backward."""
    mod, kw, calls_want = REMAT[name]
    base = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16",
                               **kw)
    masters = build_model(base, "cpu").init_masters(2)
    batch = batch_for(base, 8, "bfloat16")
    out = {}
    real = mod.checkpoint
    for remat in ("none", "block"):
        tm = build_model(dataclasses.replace(base, remat=remat), "cpu")
        calls = []

        def counting(*a, **k):
            calls.append(1)
            return real(*a, **k)
        monkeypatch.setattr(mod, "checkpoint", counting)
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, grads = port_value_and_grad(tm, masters, batch)
        out[remat] = (loss, grads, len(calls), sum(saved))
    assert out["none"][2] == 0 and out["block"][2] == calls_want
    assert out["block"][3] < out["none"][3]
    assert torch.equal(out["none"][0], out["block"][0])
    for k, g in out["none"][1].items():
        assert torch.equal(g, out["block"][1][k]), k




def test_train_refuses_encdec_with_the_reason(tmp_path):
    """``train()`` feeds tokens only: on an enc-dec config it raises, and
    says so, before it builds anything; the launcher's ``--arch`` does
    the same; a batch without frames raises in ``Model.loss``."""
    cfg = get_config("seamless-m4t-medium").reduced()
    tc = TrainConfig(total_steps=1, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="feeds tokens only"):
        tloop.train(cfg, tc, seq_len=8, device="cpu", log_fn=lambda s: None)
    from repro_torch.launch import train as launch
    with pytest.raises(ValueError, match="feeds tokens only"):
        launch.main(["--arch", "seamless-m4t-medium", "--reduced",
                     "--steps", "1", "--ckpt", str(tmp_path),
                     "--device", "cpu"])
    tm = build_model(cfg, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    with pytest.raises(ValueError, match="needs 'frames'"):
        tm.loss(tm.init_masters(0), {"tokens": tokens, "labels": tokens})
