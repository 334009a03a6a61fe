"""The port's flash attention on the CPU: its plain version
(``repro_torch.kernels.ref.flash_attention``) and the CPU dispatch of
``ops.flash_attention`` against the JAX package's Pallas kernel in
interpret mode and its plain version, on the same numpy inputs; the
dispatch of a CUDA tensor to the kernel; the attention layers
(``attention_dense``, ``attention_stream``'s chunk loop, ``expand_kv``)
against the reference's; a numeric model of the wgmma kernel's
arithmetic (unscaled bf16 Q.K^T in fp32, the fp32 scale, the online
softmax over 128-key tiles, P split into two bf16 products) against
both, and the case that shows the split is needed; a numeric model of
the SIMT kernel's tile walk (its query blocks, the 64-key tiles it skips,
the tiles it masks) and arithmetic against the Pallas kernel and the
reference; which kernel a CUDA call routes to, and with which query
block, with the library faked (olmo-1b's fp32 prefill and the enc-dec
stream forward included). The CUDA kernels themselves are
held to the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerance: fp32 rtol=2e-5, atol=2e-5, the reference's ``test_flash_sweep``
tolerance (summation order; the TPU kernel scales q before the dot, the
plain versions divide the scores after it). bf16: within one rounding to
bf16 (2^-8 |b|) plus 2^-16 max|v| of the reference's fp32 result on the
same inputs (``flash_check``'s tolerance in chip_smoke.py). Attention
layers: rtol=1e-5, atol=1e-5 (fp32 sum order).
"""
import dataclasses
import re
from pathlib import Path

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


def _bf16_tol(exact, v):
    """``flash_check``'s bf16 tolerance around the fp32 result ``exact``:
    one rounding to bf16 plus 2^-16 max|v|."""
    return 2.0 ** -8 * np.abs(exact) + 2.0 ** -16 * float(np.abs(v).max())


def _wgmma_model(q, k, v, *, causal=True, window=0, bk=128, split=True):
    """The wgmma kernel's arithmetic in plain torch, for bf16 q, k, v
    (B, S, H, hd): per 128-key tile, S = q.k^T of the unscaled bf16
    inputs summed in fp32, times fp32(1/sqrt(hd)); masked scores -1e30,
    positions past S -inf; fp32 online softmax (m, l = sum of the fp32
    p); O = O * corr + P_hi.V + P_lo.V with P_hi = bf16(p), P_lo =
    bf16(p - P_hi) (``split=False``: P_hi alone), each product of bf16
    operands exact and summed in fp32; out = O / max(l, 1e-30) as bf16.
    """
    b, s, h, hd = q.shape
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    pos = torch.arange(s)
    m = torch.full((b, h, s, 1), -torch.inf)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, hd))
    for k0 in range(0, s, bk):
        kp = pos[k0:k0 + bk]
        sc = (qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
        keep = torch.ones((s, len(kp)), dtype=torch.bool)
        if causal:
            keep &= kp[None, :] <= pos[:, None]
        if window:
            keep &= kp[None, :] > pos[:, None] - window
        sc = torch.where(keep, sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + bk]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + bk]
        acc = acc * corr + pv
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [200, 256])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 50),
                                           (False, 0)])
def test_wgmma_model_matches_pallas_and_ref(hd, s, causal, window):
    """The wgmma kernel's arithmetic (``_wgmma_model``) and the Pallas
    kernel in interpret mode, on the same bf16 inputs, each within the
    bf16 tolerance of the reference's fp32 result on the widened inputs.
    S = 200 leaves a ragged last tile (the kernel's rows past S are zero
    and masked)."""
    q, k, v = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)
               for x in _qkv((1, s, 2, hd), seed=s + hd + window))
    exact = np.asarray(jref.flash_attention(q, k, v, causal=causal,
                                            window=window))
    blk = 40 if s % 64 else 64
    pallas = np.asarray(flash_attention_pallas(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=causal, window=window, bq=blk, bk=blk, interpret=True),
        np.float32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    model = _wgmma_model(tq, tk, tv, causal=causal, window=window)
    plain = tref.flash_attention(tq.float(), tk.float(), tv.float(),
                                 causal=causal, window=window)
    np.testing.assert_allclose(plain.numpy(), exact, rtol=RTOL, atol=ATOL)
    tol = _bf16_tol(exact, v)
    assert model.dtype == torch.bfloat16
    assert (np.abs(model.float().numpy() - exact) <= tol).all()
    assert (np.abs(pallas - exact) <= tol).all()


@pytest.mark.parametrize("hd", [64, 128])
def test_wgmma_split_is_needed_where_values_cancel(hd):
    """Rows where two keys share the weight, p = 1 and p = exp(-c 3.25 /
    sqrt(hd)) for c near 1 (neither normalised weight representable in
    bf16), and their values (1 and -1.5 in column 0) nearly cancel, so
    the output there is near 0: one bf16 P errs by up to 2^-8 p |v|,
    far above the tolerance 2^-8 |out| + 2^-16 max|v|; the P_hi + P_lo
    split stays inside it."""
    s, h = 64, 2
    c = 1.0 + 2.0 ** -7 * np.arange(-s // 2, s // 2)  # bf16-exact, near 1
    q = np.zeros((1, s, h, hd), np.float32)
    q[0, :, :, 0] = c[:, None]
    k = np.zeros((1, s, h, hd), np.float32)
    k[0, 0, :, 0] = 3.25 * np.sqrt(hd) / 8      # score 3.25 c / 8
    k[0, 2:, :, 0] = -1e4                        # weight exactly 0
    v = np.random.default_rng(hd).uniform(-1.5, 1.5, (1, s, h, hd))
    v = v.astype(np.float32)
    v[0, 0, :, 0], v[0, 1, :, 0] = 1.0, -1.5
    q, k, v = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)
               for x in (q, k, v))
    exact = np.asarray(jref.flash_attention(q, k, v, causal=False))
    tol = _bf16_tol(exact, v)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    near0 = np.abs(exact[..., 0]) < 0.01
    assert near0.sum() >= 4
    split = _wgmma_model(tq, tk, tv, causal=False).float().numpy()
    assert (np.abs(split - exact) <= tol).all()
    unsplit = _wgmma_model(tq, tk, tv, causal=False,
                           split=False).float().numpy()
    over = np.abs(unsplit - exact) > tol
    assert over[..., 0][near0].any()


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


class _FakeLibrary:
    """Both flash kernels' C entry points, recording each launch."""

    def __init__(self):
        self.calls, self.err = [], 0

    def flash_attention_launch(self, *args):
        self.calls.append(("simt", args))
        return self.err

    def flash_attention_wgmma_launch(self, *args):
        self.calls.append(("wgmma", args))
        return self.err


@pytest.fixture
def fake_card(monkeypatch):
    """``flash_attention_cuda`` on CPU tensors with the kernel libraries
    faked: the wrapper's checks, copies and routing run as on the card,
    the launch only records its route and arguments."""
    lib, built = _FakeLibrary(), []
    monkeypatch.setattr(flash_attention, "_cuda_device", lambda q: q.device)
    monkeypatch.setattr(flash_attention.build, "library",
                        lambda name: built.append(name) or lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        type("Stream", (), {"cuda_stream": 0})())
    monkeypatch.setattr(flash_attention, "launches_by_route",
                        {"wgmma": 0, "simt": 0})
    lib.built = built
    return lib


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt")])
def test_cuda_call_routes_by_type_and_head_dim(fake_card, dtype, hd, want):
    """bf16 at hd 64 and 128 launches the wgmma kernel, every fp32 input
    and bf16 at hd 16 and 32 the SIMT kernel; one launch, counted in the
    total and under its route."""
    q = torch.zeros((1, 8, 2, hd), dtype=dtype)
    before = flash_attention.launches
    out = flash_attention.flash_attention_cuda(q, q, q, causal=False,
                                               window=3)
    assert flash_attention.route(dtype, hd) == want
    assert [c[0] for c in fake_card.calls] == [want]
    assert fake_card.built == [{"wgmma": "flash_attention_wgmma",
                                "simt": "flash_attention"}[want]]
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_route == {
        "wgmma": int(want == "wgmma"), "simt": int(want == "simt")}
    assert out.shape == q.shape and out.dtype == dtype
    args = fake_card.calls[0][1]
    assert args[4:8] == (1, 8, 2, hd)      # B, S, H, hd after the pointers


@pytest.mark.parametrize("shape,dtype,bq", [
    ((2, 2032, 16, 128), torch.float32, 128),   # olmo-1b fp32, 2032 bucket
    ((2, 1000, 16, 128), torch.float32, 128),   # olmo-1b fp32, 1000 bucket
    ((2, 1000, 4, 16), torch.float32, 64),      # reduced llama3-8b fp32
    ((1, 200, 3, 32), torch.bfloat16, 64),
    ((1, 200, 3, 64), torch.float32, 128)])
def test_simt_query_block_at_the_paths_shapes(fake_card, shape, dtype, bq):
    """The SIMT kernel's query block at the fp32 serving paths' launches
    and the route's other inputs: its C dispatch instantiates RQ = bq / 16
    rows a lane for the head dim (read from the source), which
    ``SIMT_BLOCK_Q`` mirrors for the model of the walk, and the launch
    receives B, S, H, hd and the type, nothing that could pick another
    block."""
    hd = shape[3]
    src = (Path(flash_attention.__file__).parents[1] / "csrc"
           / "flash_attention.cu").read_text()
    rq = re.findall(rf"if \(hd == {hd}\)\s*return launch<T, {hd}, (\d+)>",
                    src)
    assert [16 * int(r) for r in rq] == [bq]
    assert flash_attention.SIMT_BLOCK_Q[hd] == bq
    q = torch.zeros(shape, dtype=dtype)
    flash_attention.flash_attention_cuda(q, q, q)
    (route, args), = fake_card.calls
    assert route == "simt"
    assert args[4:9] == (*shape, int(dtype == torch.bfloat16))
    assert args[9:11] == (1, 0)               # causal, no window


def test_olmo_fp32_prefill_routes_every_layer_to_simt(fake_card,
                                                      monkeypatch):
    """olmo-1b in fp32 (its published type) at its depth (16 layers) and
    head dim (128), narrowed to 2 heads: with the prefill's attention
    handed to the CUDA wrapper (the libraries faked; the layer then
    takes the plain version's output), every layer's launch takes the
    SIMT kernel at hd 128 (128-query blocks) in fp32, causal."""
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config("olmo-1b"), dtype="float32",
                              d_model=256, num_heads=2, num_kv_heads=2,
                              d_ff=512, vocab_size=512,
                              head_pad_multiple=1)
    assert (cfg.num_layers, cfg.hd()) == (16, 128)
    eng = ServeEngine(cfg, device="cpu", max_len=48, batch_size=2, seed=0)
    toks = np.random.default_rng(3).integers(0, 512, (2, 40))

    def on_card(q, k, v, *, causal=True, window=0, chunk=1024):
        flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                             window=window)
        return tref.flash_attention(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(TL, "attention_stream", on_card)
    logits, _ = eng.model.prefill(eng.params, {"tokens": toks}, 48)
    assert logits.shape == (2, 1, 512) and bool(logits.isfinite().all())
    assert [c[0] for c in fake_card.calls] == ["simt"] * 16
    assert {c[1][4:10] for c in fake_card.calls} == {(2, 40, 2, 128, 0,
                                                      1)}
    assert flash_attention.launches_by_route == {"wgmma": 0, "simt": 16}


def test_encdec_stream_sends_only_decoder_self_attention(fake_card,
                                                         monkeypatch):
    """seamless-m4t-medium's stream forward, narrowed to 2 heads of hd 64
    in bf16 (its head dim and type: the wgmma route), 24 frames: with the
    decoder's ``attention_stream`` handed to the CUDA wrapper (the
    libraries faked; the layer then takes the plain version's output),
    each decoder layer launches the wgmma kernel once at the tokens'
    (B, S, H, hd), causal; the encoder (frames against frames) and the
    cross-attention (tokens against frames) take ``attention_dense``,
    non-causal, and never the kernel."""
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("seamless-m4t-medium").reduced(),
                              d_model=128, num_heads=2, num_kv_heads=2,
                              head_dim=64, frontend_tokens=24)
    assert (cfg.dtype, cfg.hd(), cfg.enc_layers) == ("bfloat16", 64, 2)
    m = build_model(cfg, "cpu")
    p = m.init(0)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 256, (2, 16)),
             "frames": rng.normal(size=(2, 24, 128)).astype(np.float32)}
    dense, dense_call = [], TL.attention_dense

    def on_card(q, k, v, *, causal=True, window=0, chunk=1024):
        flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                             window=window)
        return tref.flash_attention(q, k, v, causal=causal, window=window)

    def recording(q, k, v, **kw):
        dense.append((q.shape[1], k.shape[1], kw.get("causal", True)))
        return dense_call(q, k, v, **kw)
    monkeypatch.setattr(TL, "attention_stream", on_card)
    monkeypatch.setattr(TL, "attention_dense", recording)
    logits, _ = m.forward(p, batch, mode="stream")
    assert logits.shape == (2, 16, 256) and bool(logits.isfinite().all())
    assert [c[0] for c in fake_card.calls] == ["wgmma"] * cfg.num_layers
    assert {c[1][4:8] for c in fake_card.calls} == {(2, 16, 2, 64)}
    assert flash_attention.launches_by_route == {"wgmma": 2, "simt": 0}
    assert dense == [(24, 24, False)] * 2 + [(16, 24, False)] * 2


@pytest.mark.parametrize("err", [1, 9000, 10001])
def test_failing_wgmma_launch_raises(fake_card, err):
    """A launch error of the wgmma kernel (a CUDA error, no tensor-map
    encoder in the driver, a refused tensor map) raises: the SIMT kernel
    and the plain version never run in its place, and nothing is
    counted."""
    fake_card.err = err
    q = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match=f"error {err}"):
        flash_attention.flash_attention_cuda(q, q, q)
    assert [c[0] for c in fake_card.calls] == ["wgmma"]
    assert flash_attention.launches == before
    assert flash_attention.launches_by_route == {"wgmma": 0, "simt": 0}


def test_failing_wgmma_build_raises(fake_card, monkeypatch):
    """A build failure of the wgmma library raises too; no other library
    is asked for."""
    asked = []

    def broken(name):
        asked.append(name)
        raise RuntimeError("nvcc failed for csrc/flash_attention_wgmma.cu")
    monkeypatch.setattr(flash_attention.build, "library", broken)
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        flash_attention.flash_attention_cuda(q, q, q)
    assert asked == ["flash_attention_wgmma"]


def test_kernel_named_by_the_caller(fake_card):
    """``_launch`` with ``"simt"`` launches the SIMT kernel on a bf16
    hd-128 input (to compare the kernels at one shape); ``"wgmma"``
    takes only the inputs its route takes; the public wrapper has no
    such option."""
    q = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    flash_attention._launch(q, q, q, True, 0, "simt")
    assert [c[0] for c in fake_card.calls] == ["simt"]
    assert flash_attention.launches_by_route == {"wgmma": 0, "simt": 1}
    with pytest.raises(ValueError, match="no 'wgmma' kernel"):
        flash_attention._launch(q.float(), q.float(), q.float(), True, 0,
                                "wgmma")
    with pytest.raises(ValueError, match="no 'tiled' kernel"):
        flash_attention._launch(q, q, q, True, 0, "tiled")
    with pytest.raises(TypeError, match="kernel"):
        flash_attention.flash_attention_cuda(q, q, q, kernel="simt")


def test_wgmma_route_copies_strides_tma_cannot_read(fake_card):
    """Heads strided by 132 elements (4-, not 8-element aligned): the
    SIMT kernel reads the view in place, the wgmma route (TMA needs
    16-byte strides) is handed an explicit contiguous copy."""
    wide = torch.zeros((1, 8, 2, 132), dtype=torch.bfloat16)
    wide = wide.as_strided((1, 8, 2, 128), (8 * 2 * 132, 2 * 132, 132, 1))
    flash_attention._launch(wide, wide, wide, True, 0, "simt")
    flash_attention.flash_attention_cuda(wide, wide, wide)
    (r0, simt), (r1, wgmma) = fake_card.calls
    assert (r0, r1) == ("simt", "wgmma")
    assert simt[0] == wide.data_ptr()
    assert simt[-10:-1] == (8 * 2 * 132, 2 * 132, 132) * 3
    assert wgmma[0] != wide.data_ptr()
    assert wgmma[-10:-1] == (8 * 2 * 128, 2 * 128, 128) * 3


def test_cuda_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 16, 2, 16), seed=0))
    with pytest.raises(ValueError, match="CUDA kernels take CUDA tensors"):
        flash_attention.flash_attention_cuda(q, k, v)


# --------------------------------------------------- the SIMT kernel
def _simt_walk(s, bq, causal, window, bk=64):
    """The SIMT kernel's walk for a length-``s`` sequence: per query
    block (q0), the key tiles walked, each with whether the mask is
    applied on it (``csrc/flash_attention.cu``: j_begin, j_end, cut)."""
    nkt = -(-s // bk)
    for q0 in range(0, s, bq):
        j_end = min(nkt - 1, (q0 + bq - 1) // bk) if causal else nkt - 1
        lo = q0 - window
        j_begin = (lo - (bk - 1)) // bk + 1 if window and lo >= bk - 1 \
            else 0
        yield q0, [(j, (causal and j * bk + bk - 1 > q0)
                    or (window > 0 and j * bk <= q0 + bq - 1 - window)
                    or j * bk + bk > s)
                   for j in range(j_begin, j_end + 1)]


def _keep(qpos, kpos, causal, window):
    keep = torch.ones((len(qpos), len(kpos)), dtype=torch.bool)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window:
        keep &= kpos[None, :] > qpos[:, None] - window
    return keep


def _simt_model(q, k, v, *, causal=True, window=0, bq=128, bk=64):
    """The SIMT kernel's arithmetic in plain torch (fp32, or bf16
    widened): per query block of ``bq``, the 64-key tiles of
    ``_simt_walk``; scores (q * scale) . k in fp32; on a cut tile masked
    scores -1e30 and positions past S -inf; the online softmax (m, l,
    corr) and O = O * corr + P.V, skipped for a warp's bq / 8 rows on a
    tile the mask covers for all of them; out = O / max(l, 1e-30) in q's
    type. It asserts the walk's claims as it goes: every tile not walked
    is masked for every query of the block, every tile a warp skips for
    all of its rows, and no score of a walked tile that is not cut is
    masked or past S."""
    b, s, h, hd = q.shape
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    out = torch.zeros((b, h, s, hd))
    allk = torch.arange(-(-s // bk) * bk)
    for q0, tiles in _simt_walk(s, bq, causal, window, bk):
        qpos = torch.arange(q0, min(q0 + bq, s))
        walked = {j for j, _ in tiles}
        for j in set(range(-(-s // bk))) - walked:
            assert not _keep(qpos, allk[j * bk:(j + 1) * bk], causal,
                             window).any()
        qs = qf[:, :, q0:q0 + bq] * scale
        m = torch.full((b, h, len(qpos), 1), -torch.inf)
        l = torch.zeros((b, h, len(qpos), 1))
        acc = torch.zeros((b, h, len(qpos), hd))
        for j, cut in tiles:
            kpos = allk[j * bk:(j + 1) * bk]
            kt = torch.zeros((b, h, bk, hd))
            vt = torch.zeros((b, h, bk, hd))
            n = min(bk, s - j * bk)
            kt[:, :, :n] = kf[:, :, j * bk:j * bk + n]
            vt[:, :, :n] = vf[:, :, j * bk:j * bk + n]
            sc = qs @ kt.transpose(-1, -2)
            keep = _keep(qpos, kpos, causal, window)
            if cut:
                sc = torch.where(keep, sc, torch.tensor(-1e30))
                sc = torch.where(kpos < s, sc, torch.tensor(-torch.inf))
            else:
                assert keep.all() and bool((kpos < s).all())
            # a warp (bq / 8 rows) skips a tile the mask covers for all
            # of its rows
            w = bq // 8
            run = torch.ones((len(qpos), 1), dtype=torch.bool)
            for wq0 in range(q0, q0 + len(qpos), w):
                if (causal and j * bk > wq0 + w - 1) or \
                        (window and j * bk + bk - 1 <= wq0 - window):
                    assert not keep[wq0 - q0:wq0 - q0 + w].any()
                    run[wq0 - q0:wq0 - q0 + w] = False
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = torch.where(run, l * corr + p.sum(-1, keepdim=True), l)
            acc = torch.where(run, acc * corr + p @ vt, acc)
            m = torch.where(run, m_new, m)
        out[:, :, q0:q0 + bq] = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 37),
                                           (False, 0), (False, 100)])
def test_simt_model_matches_pallas_and_ref(hd, causal, window):
    """The SIMT kernel's walk and arithmetic (``_simt_model``, with its
    wrapper's query block) against the Pallas kernel in interpret mode
    and the reference's plain version, fp32, S = 256; windows that start
    and end inside a 64-key tile."""
    q, k, v = _qkv((1, 256, 2, hd), seed=hd + window)
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=64, bk=64, interpret=True))
    want = np.asarray(jref.flash_attention(q, k, v, causal=causal,
                                           window=window))
    got = _simt_model(*(torch.from_numpy(x) for x in (q, k, v)),
                      causal=causal, window=window,
                      bq=flash_attention.SIMT_BLOCK_Q[hd]).numpy()
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s", [1, 17, 63, 65, 127, 129, 200])
@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 70)])
def test_simt_model_ragged_lengths_match_ref(s, bq, causal, window):
    """S that is no multiple of the query or key block, and S below one
    block: the walk, the cut tiles and the ragged tail against the
    reference's plain version (fp32)."""
    q, k, v = _qkv((2, s, 2, 32), seed=s + bq + window)
    want = np.asarray(jref.flash_attention(q, k, v, causal=causal,
                                           window=window))
    got = _simt_model(*(torch.from_numpy(x) for x in (q, k, v)),
                      causal=causal, window=window, bq=bq).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_simt_model_bf16_widened_matches_ref():
    """bf16 at hd 16 and 32 (the SIMT route's bf16 inputs): widened on
    load, fp32 arithmetic, one rounding to bf16 at the end."""
    for hd in (16, 32):
        q, k, v = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16),
                              np.float32)
                   for x in _qkv((1, 150, 3, hd), seed=hd))
        exact = np.asarray(jref.flash_attention(q, k, v, window=20))
        tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
        got = _simt_model(tq, tk, tv, window=20,
                          bq=flash_attention.SIMT_BLOCK_Q[hd])
        assert got.dtype == torch.bfloat16
        assert (np.abs(got.float().numpy() - exact)
                <= _bf16_tol(exact, v)).all()


def test_simt_walk_keeps_longest_causal_blocks_whole():
    """Under the causal mask the last query block walks every tile up to
    its diagonal and the first only its own; only the diagonal tiles are
    cut (olmo-1b's 2032-token prefill at hd 128)."""
    walk = dict(_simt_walk(2032, 128, True, 0))
    assert [j for j, _ in walk[0]] == [0, 1]
    assert [c for _, c in walk[0]] == [True, True]
    last = walk[15 * 128]
    assert [j for j, _ in last] == list(range(32))
    assert [j for j, c in last if c] == [30, 31]
    assert sum(len(t) for t in walk.values()) == 272


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
    # as many kv heads as q heads (seamless-m4t-medium, olmo-1b): the map
    # is the identity, and the tensor comes back as it is
    for name in ("seamless-m4t-medium", "olmo-1b", "hymba-1.5b"):
        cfg, jcfg = get_config(name), jget(name)
        identity = np.array_equal(np.asarray(JL.head_map(jcfg)),
                                  np.arange(jcfg.hp()))
        t = torch.from_numpy(np.random.default_rng(10).normal(
            size=(1, 3, cfg.kvp(), 4)).astype(np.float32))
        np.testing.assert_array_equal(
            TL.expand_kv(cfg, t),
            np.asarray(JL.expand_kv(jcfg, t.numpy())))
        assert (TL.expand_kv(cfg, t) is t) == identity == \
            (name != "hymba-1.5b")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_plain_version_by_query_blocks_equals_whole(causal, window):
    """``ref.flash_attention`` on blocks of queries (``q_offset``, their
    positions) gives the whole call's rows, and ``chip_smoke.flash_check``
    by blocks of rows judges a kernel's output as the whole call does:
    the same verdict, error and count over the tolerance, on an output
    within it and on one pushed past it."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((2, 96, 3, 16), generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    whole = tref.flash_attention(q.float(), k.float(), v.float(),
                                 causal=causal, window=window)
    blocks = torch.cat([tref.flash_attention(
        q[:, r0:r0 + 32].float(), k.float(), v.float(), causal=causal,
        window=window, q_offset=r0) for r0 in range(0, 96, 32)], dim=1)
    torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=1e-6)
    got = whole.to(torch.bfloat16)
    bad = got.clone()
    bad[1, 70, 2, 5] += 0.25
    for out, verdict in ((got, True), (bad, False)):
        a = cs.flash_check(torch, tref, q, k, v, out, causal, window,
                           score_err=True)
        b = cs.flash_check(torch, tref, q, k, v, out, causal, window,
                           score_err=True, rows=32)
        assert a[0] is b[0] is verdict and a[2] == b[2]
        assert b[1] == pytest.approx(a[1], rel=1e-5, abs=1e-7)
