"""The port's flash attention on the CPU: its plain version
(``repro_torch.kernels.ref.flash_attention``) and the CPU dispatch of
``ops.flash_attention`` against the JAX package's Pallas kernel in
interpret mode and its plain version, on the same numpy inputs; the
dispatch of a CUDA tensor to the kernel; the attention layers
(``attention_dense``, ``attention_stream``'s chunk loop, ``expand_kv``)
against the reference's. The CUDA kernel itself is held
to the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerance: fp32 rtol=2e-5, atol=2e-5, the reference's ``test_flash_sweep``
tolerance (summation order; the TPU kernel scales q before the dot, the
plain versions divide the scores after it). bf16: within one rounding to
bf16 (2^-8 |b|) plus 2^-16 max|v| of the reference's fp32 result on the
same inputs. Attention layers: rtol=1e-5, atol=1e-5 (fp32 sum order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL

torch.set_num_threads(1)

RTOL = ATOL = 2e-5


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,s,h,hd", [(1, 64, 2, 16), (2, 128, 3, 32),
                                      (1, 32, 1, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_plain_matches_pallas_and_ref(b, s, h, hd, causal, window):
    """The reference's sweep (tests/test_kernels.py::test_flash_sweep):
    the port's plain version, and ``ops.flash_attention`` on CPU tensors,
    against the Pallas kernel (interpret mode) and the reference's plain
    version."""
    q, k, v = _qkv((b, s, h, hd), seed=s + hd)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=32, bk=32, interpret=True))
    want = np.asarray(jref.flash_attention(q, k, v, causal=causal,
                                           window=window))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tref.flash_attention(tq, tk, tv, causal=causal, window=window)
    via_ops = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(got, via_ops)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s,causal,window", [(50, True, 0), (100, True, 17),
                                             (77, False, 0)])
def test_plain_ragged_length_matches_ref(s, causal, window):
    """S that no block size divides (the Pallas kernel asserts S % bq ==
    0; the CUDA kernel takes any S): against the reference's plain
    version."""
    q, k, v = _qkv((2, s, 3, 32), seed=s)
    want = np.asarray(jref.flash_attention(q, k, v, causal=causal,
                                           window=window))
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_bf16_matches_pallas():
    """bf16 inputs: widened to fp32 for the scores and the weighted sum,
    the output cast back to bf16 (the reference's test_flash_bf16
    inputs)."""
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16)
               for x in _qkv((1, 64, 2, 32), seed=3))
    pallas = np.asarray(flash_attention_pallas(q, k, v, bq=32, bk=32,
                                               interpret=True), np.float32)
    exact = np.asarray(jref.flash_attention(
        q.astype(jnp.float32), k.astype(jnp.float32),
        v.astype(jnp.float32)))
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                  for x in (q, k, v))
    got = tref.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    tol = 2.0 ** -8 * np.abs(exact) + 2.0 ** -16 * float(np.abs(
        np.asarray(v, np.float32)).max())
    assert (np.abs(got - exact) <= tol).all()
    assert (np.abs(pallas - exact) <= tol).all()


def test_cpu_dispatch_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 16, 2, 16), seed=0))
    before = flash_attention.launches
    flash_attention.flash_attention(q, k, v)
    ops.flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == before


class _CudaTensor:
    """Stands in for a CUDA tensor where there is no card."""
    device = torch.device("cuda")
    is_cuda = True

    def __init__(self, shape):
        self.shape = shape


def test_cuda_tensor_reaches_the_kernel(monkeypatch):
    """``ops.flash_attention`` and ``attention_stream`` (sq == skv) hand
    a CUDA tensor to the CUDA wrapper (faked here, as there is no card)
    and never to the plain version or the chunk loop."""
    seen = []
    monkeypatch.setattr(flash_attention, "flash_attention_cuda",
                        lambda q, k, v, causal, window:
                        seen.append((q, causal, window)) or q)
    monkeypatch.setattr(tref, "flash_attention", lambda *a, **k: pytest.fail(
        "the plain version ran for a CUDA tensor"))
    t = _CudaTensor((1, 8, 2, 16))
    assert ops.flash_attention(t, t, t, causal=False, window=3) is t
    assert TL.attention_stream(t, t, t, causal=True) is t
    assert seen == [(t, False, 3), (t, True, 0)]


def test_cuda_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 16, 2, 16), seed=0))
    with pytest.raises(ValueError, match="CUDA kernels take CUDA tensors"):
        flash_attention.flash_attention_cuda(q, k, v)


# ----------------------------------------------------- attention layers
@pytest.mark.parametrize("causal,window,chunk", [(True, 0, 16),
                                                 (True, 20, 32),
                                                 (False, 0, 64)])
def test_attention_layers_match_reference(causal, window, chunk):
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jd = JL.attention_dense(q, k, v, causal=causal, window=window)
    js = JL.attention_stream(q, k, v, causal=causal, window=window,
                             chunk=chunk)
    td = TL.attention_dense(tq, tk, tv, causal=causal, window=window)
    ts = TL.attention_stream(tq, tk, tv, causal=causal, window=window,
                             chunk=chunk)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)
    # decode form: one query at an offset against a longer, partly valid
    # cache
    jq = JL.attention_dense(q[:, :1], k, v, causal=False, q_offset=40,
                            kv_valid_len=41, window=window)
    tq1 = TL.attention_dense(tq[:, :1], tk, tv, causal=False, q_offset=40,
                             kv_valid_len=41, window=window)
    np.testing.assert_allclose(tq1.numpy(), jq, rtol=1e-5, atol=1e-5)


def test_attention_stream_needs_whole_chunks():
    """The reference's chunk loop needs skv % min(chunk, skv) == 0 (it
    asserts); the port's raises the same way."""
    t = torch.zeros((1, 40, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        TL.attention_stream(t, t, t, chunk=16)


def test_expand_kv_and_head_mask_match_reference():
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              head_pad_multiple=8)
    jcfg = dataclasses.replace(jget("llama3-8b").reduced(),
                               head_pad_multiple=8)
    assert cfg.hp() == 8 and cfg.kvp() == 2
    np.testing.assert_array_equal(TL.head_map(cfg).numpy(),
                                  np.asarray(JL.head_map(jcfg)))
    np.testing.assert_array_equal(TL.head_mask(cfg).numpy(),
                                  np.asarray(JL.head_mask(jcfg)))
    k = np.random.default_rng(9).normal(size=(2, 5, 2, 16)).astype(
        np.float32)
    np.testing.assert_array_equal(TL.expand_kv(cfg, torch.from_numpy(k)),
                                  np.asarray(JL.expand_kv(jcfg, k)))
