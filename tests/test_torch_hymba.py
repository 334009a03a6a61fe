"""The port's hymba (``models/hymba.py``) against the JAX package on the
CPU, reduced config (2 layers: one windowed, one global; window 16, hd
16, 2 SSM heads of state 4), the reference's parameters carried across
by ``params_from_numpy``: ``mamba_scan`` against ``mamba_step`` and
against the reference's scan at chunk 4 and 128, the ring-buffer decode
past the window (40 positions, the 16-slot ring wrapped twice),
``forward`` in train and stream modes, ``prefill`` + the decode replay
that ``ServeEngine`` runs, and ``return_hidden``.

Tolerances: the reference's, 1e-4 of the largest magnitude in fp32
(``tests/test_models.py``'s scan, step and ring tests). In bf16 the
models are held to the reference evaluated op by op (``jax.disable_jit()``)
within 2e-2 of the largest magnitude: the port's scan combines in
another tree than ``lax.associative_scan`` and its ``exp`` is torch's,
so a few fp32 states differ in the last bits and flip a bf16 rounding
of the branch's output (the Mamba layer alone agrees bit for bit at 16
positions and within 2e-4 of its scale at 40); the reference as it runs
compiles the scanned blocks and lies ~3% of the largest logit from its
own op-by-op result here.
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
from repro.models import hymba as JH
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy, \
    params_to_numpy
from repro_torch.models import hymba as TH
from repro_torch.models import spec as S
from repro_torch.models import transformer as T
from repro_torch.serve.engine import GenRequest, ServeEngine

torch.set_num_threads(1)

FP32_TOL = 1e-4
BF16_TOL = 2e-2
DTYPES = ["float32", "bfloat16"]
NAME = "hymba-1.5b"


def _cfgs(dtype):
    j = dataclasses.replace(jget(NAME).reduced(), dtype=dtype)
    t = dataclasses.replace(get_config(NAME).reduced(), dtype=dtype)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@pytest.fixture(scope="module")
def pair():
    out = {}
    for dtype in DTYPES:
        jc, tc = _cfgs(dtype)
        jm = jbuild(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
        out[dtype] = (jc, jm, jp, tc, build_model(tc, "cpu"), tp)
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


def _tokens(tc, shape=(2, 40), seed=1):
    return np.random.default_rng(seed).integers(0, tc.vocab_size, shape)


def _mamba(pair_dtype):
    jc, _, jp, tc, _, tp = pair_dtype
    return jc, jax.tree.map(lambda a: a[0, 0], jp["win"]["mamba"]), tc, \
        tp.win[0][0].mamba


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk,s", [(4, 16), (128, 40), (128, 256)])
def test_mamba_scan_matches_reference(pair, dtype, chunk, s):
    jc, jl, tc, tl = _mamba(pair[dtype])
    x = np.random.default_rng(s).normal(size=(2, s, tc.d_model)).astype(
        np.float32)
    jy, (jh, jconv) = JH.mamba_scan(jc, jl, jnp.asarray(x, jnp.dtype(dtype)),
                                    chunk=chunk)
    ty, (th, tconv) = TH.mamba_scan(
        tc, tl, torch.from_numpy(x).to(getattr(torch, dtype)), chunk=chunk)
    tol = FP32_TOL if dtype == "float32" else 2e-3
    _close(ty, jy, tol)
    _close(th, jh, FP32_TOL)
    assert th.dtype == torch.float32
    _close(tconv, jconv, 0.0)


def test_mamba_scan_matches_step(pair):
    """The chunked scan (chunk 4: three chunks carrying the state) equals
    the one-token step run 12 times, outputs and states."""
    _, _, tc, tl = _mamba(pair["float32"])
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 12, tc.d_model)).astype(np.float32))
    y_scan, (h_scan, conv_scan) = TH.mamba_scan(tc, tl, x, chunk=4)
    h = torch.zeros(2, TH._dm(tc), tc.ssm_state)
    conv = torch.zeros(2, TH.CONV_K - 1, TH._dm(tc))
    ys = []
    for t in range(12):
        y, (h, conv) = TH.mamba_step(tc, tl, x[:, t:t + 1], (h, conv))
        ys.append(y)
    _close(torch.cat(ys, dim=1), y_scan.numpy(), FP32_TOL)
    _close(h, h_scan.numpy(), FP32_TOL)
    _close(conv, conv_scan.numpy(), FP32_TOL)
    # a state carried in gives the same as the scan over both halves
    y1, st = TH.mamba_scan(tc, tl, x[:, :8], chunk=4)
    y2, (h2, _) = TH.mamba_scan(tc, tl, x[:, 8:], state=st, chunk=4)
    _close(torch.cat([y1, y2], dim=1), y_scan.numpy(), FP32_TOL)
    _close(h2, h_scan.numpy(), FP32_TOL)


def test_scan_keeps_the_reference_chunk_condition(pair):
    _, _, tc, tl = _mamba(pair["float32"])
    x = torch.zeros(1, 200, tc.d_model)
    with pytest.raises(ValueError, match="multiple"):
        TH.mamba_scan(tc, tl, x)
    TH.mamba_scan(tc, tl, x[:, :100])          # one chunk of 100


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["train", "stream"])
def test_forward_matches_reference(pair, dtype, mode):
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = _tokens(tc)
    with _ref_run(dtype):
        want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, mode=mode)
    got, aux = tm.forward(tp, {"tokens": toks}, mode=mode)
    assert got.shape == (2, 40, tc.padded_vocab()) and float(aux) == 0.0
    _close(got, want, _tol(dtype))
    if dtype == "float32":
        np.testing.assert_array_equal(
            got.numpy()[..., :tc.vocab_size].argmax(-1),
            np.asarray(want)[..., :jc.vocab_size].argmax(-1))
    last, _ = tm.forward(tp, {"tokens": toks}, mode=mode, last_only=True)
    _close(last, got.float().numpy()[:, -1:], _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ring_buffer_decode_past_the_window(pair, dtype):
    """40 decode steps from an empty cache (the 16-slot ring of the
    windowed layer wraps twice): each step's logits against the
    reference's decode, and the last against the stream forward's last
    position; the ring holds the last 16 positions, in slot order
    position % 16, with the reference's K/V."""
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = _tokens(tc, seed=2)
    jcache, tcache = jm.init_cache(2, 48), tm.init_cache(2, 48)
    assert tcache.wk.shape == tuple(jcache.wk.shape)
    tol = _tol(dtype)
    decode = jax.jit(jm.decode) if dtype == "float32" else jm.decode
    with _ref_run(dtype):
        for t in range(40):
            jl, jcache = decode(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
            tl, tcache = tm.decode(tp, tcache, toks[:, t:t + 1])
            assert tcache.length == t + 1
            _close(tl, jl, tol, f"step {t}")
    np.testing.assert_array_equal(tcache.wpos.numpy(),
                                  np.asarray(jcache.wpos))
    assert sorted(tcache.wpos[0, 0].tolist()) == list(range(24, 40))
    assert tcache.wpos[0, 0, 39 % 16] == 39
    for name in ("wk", "wv", "gk", "gv", "w_ssm", "g_ssm"):
        _close(getattr(tcache, name), getattr(jcache, name), tol, name)
    stream, _ = tm.forward(tp, {"tokens": toks}, mode="stream",
                           last_only=True)
    _close(tl, stream.float().numpy(), tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_replay_match_reference(pair, dtype):
    """``prefill`` is a stream forward plus an empty cache (length 0, the
    reference's contract); ``ServeEngine`` replays the prompt through
    decode to fill it and then generates: its tokens at fp32 equal the
    reference engine's on the same weights."""
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = _tokens(tc, seed=3)
    with _ref_run(dtype):
        jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 48)
    tl, tcache = tm.prefill(tp, {"tokens": toks}, 48)
    assert tcache.length == 0 and int(jcache.length) == 0
    assert (tcache.wpos == -1).all()
    _close(tl, jl, _tol(dtype))
    for t in range(40):
        rl, tcache = tm.decode(tp, tcache, toks[:, t:t + 1])
    _close(rl, tl.float().numpy(), _tol(dtype))
    if dtype == "float32":
        from repro.serve.engine import GenRequest as JGenRequest
        from repro.serve.engine import ServeEngine as JServeEngine
        jeng = JServeEngine(jc, params=jp, max_len=48, batch_size=2)
        teng = ServeEngine(tc, tp, device="cpu", max_len=48, batch_size=2)
        reqs = [toks[0], toks[1], toks[0][:20]]
        want = jeng.generate([JGenRequest(r.astype(np.int32), 5)
                              for r in reqs])
        got = teng.generate([GenRequest(r.astype(np.int32), 5)
                             for r in reqs])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


@pytest.mark.parametrize("dtype", DTYPES)
def test_return_hidden_matches_reference(pair, dtype):
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = _tokens(tc, seed=4)
    with _ref_run(dtype):
        want = jm.embedding(jp, {"tokens": jnp.asarray(toks)})
    got = tm.embedding(tp, {"tokens": toks})
    assert got.dtype == torch.float32 and got.shape == (2, tc.d_model)
    _close(got, want, _tol(dtype))


def test_params_types_and_carry(pair):
    """``a_log`` is held in fp32 whatever the compute type (the reference
    reads it with ``astype(float32)``); the other matrices in bf16; the
    doubly stacked ``win/*`` (G, W, ...) paths map to ``win.g.w.*`` and
    back exactly."""
    jc, jm, jp, tc, tm, tp = pair["bfloat16"]
    blk = tp.win[0][0]
    assert blk.mamba.a_log.dtype == torch.float32
    assert tp.glob[0].mamba.a_log.dtype == torch.float32
    assert {blk.mamba.in_proj.dtype, blk.mamba.conv_w.dtype,
            blk.attn.wq.dtype, blk.mlp.w_up.dtype} == {torch.bfloat16}
    assert {blk.norm1.dtype, blk.mamba.dt_bias.dtype,
            blk.mamba.d_skip.dtype} == {torch.float32}
    tree = jax.tree.map(np.asarray, jp)
    np.testing.assert_array_equal(blk.mamba.a_log.numpy(),
                                  tree["win"]["mamba"]["a_log"][0, 0])
    names = {n for n, _ in tp.named_parameters()}
    want = set()
    for path, d in S.iter_defs(TH.model_defs(tc)):
        lead = d.shape[:S.n_stacked(d)]
        want |= {T.port_name(path, *i) for i in np.ndindex(*lead)}
    assert names == want and "win.0.0.mamba.a_log" in names
    f32 = params_from_numpy(pair["float32"][3], tree, "cpu")
    back = params_to_numpy(pair["float32"][3], f32)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(
            S.tree_get(back, "/".join(p.key for p in path)), leaf)
    # init draws a_log in fp32 too, and the defs are the reference's
    m = build_model(tc, "cpu")
    assert m.init(0).win[0][0].mamba.a_log.dtype == torch.float32
    assert m.n_params() == jbuild(jc).n_params()


def test_padded_heads_match_reference():
    """hymba-1.5b's own padding at a reduced width: 25 heads padded to 32
    and 5 kv heads to 8 (the full config's hp and kvp), 3 SSM heads, 4
    layers (two groups); the stream forward and the decode replay at fp32
    against the reference's."""
    kw = dict(num_heads=25, num_kv_heads=5, head_dim=8, d_model=64,
              ssm_heads=3, head_pad_multiple=16, num_layers=4,
              dtype="float32")
    jc = dataclasses.replace(jget(NAME).reduced(), **kw)
    tc = dataclasses.replace(get_config(NAME).reduced(), **kw)
    full = get_config(NAME)
    assert (tc.hp(), tc.kvp()) == (full.hp(), full.kvp()) == (32, 8)
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    tm = build_model(tc, "cpu")
    toks = _tokens(tc, seed=5)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, mode="stream")
    got, _ = tm.forward(tp, {"tokens": toks}, mode="stream")
    _close(got, want, FP32_TOL)
    cache = tm.init_cache(2, 48)
    for t in range(40):
        lg, cache = tm.decode(tp, cache, toks[:, t:t + 1])
    _close(lg, np.asarray(want)[:, -1:], FP32_TOL)
