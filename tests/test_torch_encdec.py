"""The port's encoder-decoder (``models/encdec.py``) against the JAX
package on the CPU, the reference's parameters carried across by
``params_from_numpy``.

Two configs: seamless-m4t-medium's ``reduced()`` (2 encoder and 2
decoder layers, d_model 64, 4 heads of 16, 8 frames) and the same with 2
kv heads (GQA, so ``expand_kv`` is reached in the encoder and in
cross-attention). Gaussian frames (2, 8, 64) from a numpy seed, so the
cross-attention carries signal; one token shape, (2, 16).

Covered: ``encode``, ``forward`` in both modes, ``build_cross_cache``
against the reference's ``xk`` / ``xv``, prefill (stream logits and a
cache of length 0) + the prompt's replay + decode steps against the
reference's, the replay's last logits against the stream forward's,
``return_hidden``, and zero frames (the reference's serving input):
encoder output, embeddings and ``EmbeddingServer`` rows all exactly 0,
as the reference's are.

Tolerances: fp32 within 1e-4 of the largest magnitude (sum order).
bf16 against the reference run op by op (``jax.disable_jit()``), which
the port follows, within 2^-7 of the largest magnitude: a one-unit bf16
rounding flips here and there (0.4% of the largest logit at most here).
The compiled reference fuses each scanned block and drops bf16
roundings: its logits lie 17-28% of the largest from its own op-by-op
result on these inputs, so it is no yardstick for bf16.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import encdec as JE
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy, \
    params_to_numpy
from repro_torch.models import encdec as TE
from repro_torch.models import spec as S
from repro_torch.models import transformer as T

torch.set_num_threads(1)

FP32_TOL = 1e-4
BF16_TOL = 2.0 ** -7
DTYPES = ["float32", "bfloat16"]
CFGS = {"mha": {}, "gqa": dict(num_kv_heads=2)}
NAME = "seamless-m4t-medium"
SHAPE = (2, 16)


def _cfgs(kind, dtype):
    kw = dict(CFGS[kind], dtype=dtype)
    j = dataclasses.replace(jget(NAME).reduced(), **kw)
    t = dataclasses.replace(get_config(NAME).reduced(), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@pytest.fixture(scope="module")
def pair():
    out = {}
    for kind in CFGS:
        for dtype in DTYPES:
            jc, tc = _cfgs(kind, dtype)
            jm = jbuild(jc)
            jp = jm.init(jax.random.PRNGKey(0))
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
            out[kind, dtype] = (jc, jm, jp, tc, build_model(tc, "cpu"), tp)
    return out


def _close(got, want, tol, msg=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, msg
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (msg, err)


def _tol(dtype):
    return FP32_TOL if dtype == "float32" else BF16_TOL


def _ref_run(dtype):
    """The reference as it runs in fp32; op by op in bf16."""
    return jax.disable_jit() if dtype == "bfloat16" else \
        contextlib.nullcontext()


def _batch(tc, seed=1, zero=False):
    """Tokens (2, 16) and frames (2, F, d): Gaussian, or zero in
    ``cfg.dtype`` (the reference's serving input)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tc.vocab_size, SHAPE)
    frames = np.zeros((2, tc.frontend_tokens, tc.d_model), np.float32) \
        if zero else rng.normal(size=(2, tc.frontend_tokens,
                                      tc.d_model)).astype(np.float32)
    return toks, frames


def _jbatch(jc, toks, frames):
    return {"tokens": jnp.asarray(toks),
            "frames": jnp.asarray(frames, jnp.dtype(jc.dtype))}


def _tbatch(toks, frames):
    return {"tokens": toks, "frames": frames}


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(pair, kind, dtype):
    jc, jm, jp, tc, tm, tp = pair[kind, dtype]
    _, frames = _batch(tc, seed=2)
    with _ref_run(dtype):
        want = JE.encode(jc, jp, jnp.asarray(frames, jnp.dtype(dtype)))
    got = TE.encode(tc, tp, torch.from_numpy(frames))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["train", "stream"])
def test_forward_matches_reference(pair, kind, dtype, mode):
    jc, jm, jp, tc, tm, tp = pair[kind, dtype]
    toks, frames = _batch(tc)
    with _ref_run(dtype):
        want, _ = jm.forward(jp, _jbatch(jc, toks, frames), mode=mode)
    got, aux = tm.forward(tp, _tbatch(toks, frames), mode=mode)
    assert got.shape == SHAPE + (tc.padded_vocab(),) and float(aux) == 0.0
    _close(got, want, _tol(dtype))
    if dtype == "float32":
        np.testing.assert_array_equal(
            got.numpy()[..., :tc.vocab_size].argmax(-1),
            np.asarray(want)[..., :jc.vocab_size].argmax(-1))
    last, _ = tm.forward(tp, _tbatch(toks, frames), mode=mode,
                         last_only=True)
    _close(last, got.float().numpy()[:, -1:], _tol(dtype))


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_replay_and_decode_match_reference(pair, kind, dtype):
    """``prefill``: the stream forward's last logits and a cache of length
    0 whose cross K/V equal the reference's ``build_cross_cache`` (and
    ``_enc_kv(encode(frames))`` layer by layer); then the prompt's replay
    through ``decode_step`` (what ``ServeEngine`` runs) and 2 steps more,
    each step's logits against the reference's, the self-attention K/V
    against the reference's cache, the replay's last logits against the
    prefill's."""
    jc, jm, jp, tc, tm, tp = pair[kind, dtype]
    toks, frames = _batch(tc, seed=3)
    with _ref_run(dtype):
        jl, jcache = jm.prefill(jp, _jbatch(jc, toks, frames), 24)
    tl, tcache = tm.prefill(tp, _tbatch(toks, frames), 24)
    assert tcache.length == 0 and int(jcache.length) == 0
    assert tcache.xk.shape == tuple(jcache.xk.shape)
    assert not bool(tcache.k.any())
    _close(tl, jl, _tol(dtype))
    _close(tcache.xk, jcache.xk, _tol(dtype), "xk")
    _close(tcache.xv, jcache.xv, _tol(dtype), "xv")
    enc = TE.encode(tc, tp, torch.from_numpy(frames))
    for i, bp in enumerate(tp.dec):
        ek, ev = TE._enc_kv(tc, bp, enc)
        assert torch.equal(tcache.xk[i], ek) and torch.equal(tcache.xv[i], ev)
    nxt = np.random.default_rng(4).integers(0, tc.vocab_size, (2, 2))
    steps = np.concatenate([toks, nxt], 1)
    for t in range(18):
        with _ref_run(dtype):
            jd, jcache = jm.decode(jp, jcache,
                                   jnp.asarray(steps[:, t:t + 1]))
        td, tcache = tm.decode(tp, tcache, steps[:, t:t + 1])
        assert tcache.length == t + 1
        _close(td, jd, _tol(dtype), f"step {t}")
        if t == 15:
            _close(td, tl.float().numpy(), _tol(dtype), "replay vs stream")
    _close(tcache.k, jcache.k, _tol(dtype), "k")
    _close(tcache.v, jcache.v, _tol(dtype), "v")
    with pytest.raises(ValueError, match="full"):
        tm.decode(tp, dataclasses.replace(tcache, length=24), nxt[:, :1])


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_return_hidden_matches_reference(pair, kind, dtype):
    """The platform's enc-dec embedding: the pooled encoder states."""
    jc, jm, jp, tc, tm, tp = pair[kind, dtype]
    toks, frames = _batch(tc, seed=5)
    with _ref_run(dtype):
        want = jm.embedding(jp, _jbatch(jc, toks, frames))
    got = tm.embedding(tp, _tbatch(toks, frames))
    assert got.dtype == torch.float32 and got.shape == (2, tc.d_model)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_frames_give_zero_encoder_and_embeddings(pair, dtype):
    """The reference's serving input: zero frames, and with no bias
    anywhere the encoder's output is exactly 0 (RMSNorm of 0 is 0), so
    every embedding row is 0, in both packages and through both
    ``EmbeddingServer``s; the cross-attention then adds nothing, and the
    logits differ from the Gaussian frames' run."""
    from repro.serve.engine import EmbeddingServer as JEmbeddingServer
    from repro_torch.serve.engine import EmbeddingServer
    jc, jm, jp, tc, tm, tp = pair["gqa", dtype]
    toks, zeros = _batch(tc, seed=6, zero=True)
    assert not bool(TE.encode(tc, tp, torch.from_numpy(zeros)).any())
    got = EmbeddingServer(tc, tp, device="cpu").embed(toks)
    want = JEmbeddingServer(jc, params=jp).embed(toks)
    np.testing.assert_array_equal(got, np.zeros((2, tc.d_model)))
    np.testing.assert_array_equal(np.asarray(want), got)
    _, frames = _batch(tc, seed=6)
    lz, _ = tm.forward(tp, _tbatch(toks, zeros), last_only=True)
    lg, _ = tm.forward(tp, _tbatch(toks, frames), last_only=True)
    assert float((lz.float() - lg.float()).abs().max()) > \
        0.05 * float(lg.float().abs().max())


def test_params_carry(pair):
    """``enc/*`` and ``dec/*`` map to ``enc.i.*`` / ``dec.i.*`` and back
    exactly; matrices in bf16, norm scales in fp32; the defs are the
    reference's."""
    jc, jm, jp, tc, tm, tp = pair["gqa", "bfloat16"]
    assert {tp.dec[1].xattn.wq.dtype, tp.enc[0].mlp.w_up.dtype} == \
        {torch.bfloat16}
    assert {tp.dec[1].norm_x.dtype, tp.norm_enc_f.dtype} == {torch.float32}
    assert tp.dec[0].xattn.wk.shape == (64, 2, 16)
    tree = jax.tree.map(np.asarray, jp)
    names = {n for n, _ in tp.named_parameters()}
    want = set()
    for path, d in S.iter_defs(TE.model_defs(tc)):
        lead = d.shape[:S.n_stacked(d)]
        want |= {T.port_name(path, *i) for i in np.ndindex(*lead)}
    assert names == want and "dec.1.xattn.wq" in names
    f32 = pair["gqa", "float32"][3]
    back = params_to_numpy(f32, params_from_numpy(f32, tree, "cpu"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(
            S.tree_get(back, "/".join(p.key for p in path)), leaf)
    assert build_model(tc, "cpu").n_params() == jm.n_params()
