"""The port's xLSTM (``models/xlstm.py``) against the JAX package on the
CPU, the reference's parameters carried across by ``params_from_numpy``.

Two configs: the reference's ``reduced()`` (2 layers, hd 16, chunk 8),
which has no sLSTM block (2 // ``slstm_every`` 8 = 0 groups of one: one
group of 2 mLSTMs), and the same at 4 layers with ``slstm_every=2`` (two
groups of 1 mLSTM + 1 sLSTM). One token shape, (2, 16).

Covered: ``mlstm_parallel``, ``mlstm_step`` and ``slstm_scan`` against the
reference with and without a carried state; the chunked form against the
step recurrence; chunk sizes 4, 8 and 16 against each other; ``forward``
in both modes, ``prefill`` (its state array for array), ``decode_step``
and ``return_hidden``; parameter types (``slstm/r``, ``slstm/b`` and
``mlstm/bf`` fp32), the parameter round trip, the chunk condition.

Tolerances: fp32 within 1e-4 of the largest magnitude (sum order; the
reference's own chunked-vs-sequential test allows 1e-3). bf16: a layer
against the reference run op by op (``jax.disable_jit()``) within 2^-8 of
the largest magnitude (here its outputs agree bit for bit; a gate's
``log_sigmoid`` differs in the last fp32 bit); a model against the
reference within 2^-7 (a few one-unit bf16 roundings flip across the
layers, ~0.4% of the largest logit here; for xlstm the compiled
reference equals its op-by-op result on these inputs, as it does not
for hymba or enc-dec).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import xlstm as JX
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy, \
    params_to_numpy
from repro_torch.models import spec as S
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as TX

torch.set_num_threads(1)

FP32_TOL = 1e-4
LAYER_BF16_TOL = 2.0 ** -8
BF16_TOL = 2.0 ** -7
DTYPES = ["float32", "bfloat16"]
CFGS = {"reduced": {}, "slstm": dict(num_layers=4, slstm_every=2)}
NAME = "xlstm-1.3b"
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


def _tokens(tc, seed=1):
    return np.random.default_rng(seed).integers(0, tc.vocab_size, SHAPE)


def _x(tc, seed):
    return np.random.default_rng(seed).normal(
        size=SHAPE + (tc.d_model,)).astype(np.float32)


def _as(x, dtype):
    return jnp.asarray(x, jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _layers(pair_entry):
    """The first group's first mLSTM and its sLSTM, in both packages."""
    jc, _, jp, tc, _, tp = pair_entry
    return (jc, jax.tree.map(lambda a: a[0, 0], jp["mlstm"]),
            jax.tree.map(lambda a: a[0], jp["slstm"]),
            tc, tp.mlstm[0][0], tp.slstm[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("carried", [False, True])
def test_layers_match_reference(pair, dtype, carried):
    """``mlstm_parallel``, ``slstm_scan`` and ``mlstm_step`` on the same
    input, outputs and final states; with ``carried`` each starts from the
    state the first 8 positions left (the reference's, carried in)."""
    jc, jm_, js_, tc, tm_, ts_ = _layers(pair["slstm", dtype])
    tol = FP32_TOL if dtype == "float32" else LAYER_BF16_TOL
    jx, tx = _as(_x(tc, 2), dtype)
    jst = tst = sst_j = sst_t = None
    if carried:
        with jax.disable_jit():
            _, jst = JX.mlstm_parallel(jc, jm_, jx[:, :8])
            _, sst_j = JX.slstm_scan(jc, js_, jx[:, :8])
        jx, tx = jx[:, 8:], tx[:, 8:]
        tst = tuple(torch.tensor(np.asarray(a)) for a in jst)
        sst_t = tuple(torch.tensor(np.asarray(a)) for a in sst_j)
    with jax.disable_jit():
        jy, jfin = JX.mlstm_parallel(jc, jm_, jx, state=jst)
        sy, sfin = JX.slstm_scan(jc, js_, jx, state=sst_j)
        zero = (jnp.zeros((2, 4, 16, 16)), jnp.zeros((2, 4, 16)),
                jnp.full((2, 4), -1e30))
        ky, kfin = JX.mlstm_step(jc, jm_, jx[:, :1], jst or zero)
    ty, tfin = TX.mlstm_parallel(tc, tm_, tx, state=tst)
    _close(ty, jy, tol, "mlstm out")
    for t, j in zip(tfin, jfin):
        assert t.dtype == torch.float32
        _close(t, j, FP32_TOL if dtype == "float32" else 1e-3, "mlstm state")
    ty, tfin = TX.slstm_scan(tc, ts_, tx, state=sst_t)
    _close(ty, sy, tol, "slstm out")
    for t, j in zip(tfin, sfin):
        _close(t, j, FP32_TOL if dtype == "float32" else 1e-3, "slstm state")
    tz = tuple(torch.tensor(np.asarray(a)) for a in (jst or zero))
    ty, tfin = TX.mlstm_step(tc, tm_, tx[:, :1], tz)
    _close(ty, ky, tol, "mlstm step")
    for t, j in zip(tfin, kfin):
        _close(t, j, FP32_TOL, "mlstm step state")


def test_chunked_matches_sequential(pair):
    """The chunked-parallel mLSTM (chunk 8: two chunks carrying the state)
    equals ``mlstm_step`` run 16 times, outputs and states, within the
    reference's 1e-3 (``tests/test_models.py``); the sLSTM's scan equals
    its step run 16 times within fp32 rounding (the same cell; only the
    input and output products' shapes differ)."""
    _, _, _, tc, tm_, ts_ = _layers(pair["slstm", "float32"])
    x = torch.from_numpy(_x(tc, 4))
    y_par, st_par = TX.mlstm_parallel(tc, tm_, x)
    st, ys = TX.mlstm_zero_state(2, tc.num_heads, tc.hd(), "cpu"), []
    for t in range(16):
        y, st = TX.mlstm_step(tc, tm_, x[:, t:t + 1], st)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_par.numpy(),
                               rtol=1e-3, atol=1e-3)
    for a, b in zip(st, st_par):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-3)
    y_scan, s_scan = TX.slstm_scan(tc, ts_, x)
    st, ys = None, []
    for t in range(16):
        y, st = TX.slstm_step(tc, ts_, x[:, t:t + 1],
                              st or TX.slstm_zero_state(2, 4, 16, "cpu"))
        ys.append(y)
    _close(torch.cat(ys, 1), y_scan.numpy(), FP32_TOL)
    for a, b in zip(st, s_scan):
        _close(a, b.numpy(), FP32_TOL)


@pytest.mark.parametrize("kind", list(CFGS))
def test_chunk_sizes_agree(pair, kind):
    """The chunk is a partition of the same sum: the forward's logits at
    chunks 4, 8 and 16 agree within fp32 rounding (the reference's
    ``test_mlstm_chunk_size_is_math_equivalent`` allows 1e-3)."""
    _, _, _, tc, tm, tp = pair[kind, "float32"]
    toks = _tokens(tc, seed=5)
    base, _ = tm.forward(tp, {"tokens": toks})
    for chunk in (4, 16):
        cfg = dataclasses.replace(tc, mlstm_chunk=chunk)
        got, _ = build_model(cfg, "cpu").forward(tp, {"tokens": toks})
        _close(got, base.numpy(), FP32_TOL, f"chunk {chunk}")


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["train", "stream"])
def test_forward_matches_reference(pair, kind, dtype, mode):
    jc, jm, jp, tc, tm, tp = pair[kind, dtype]
    toks = _tokens(tc)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, mode=mode)
    got, aux = tm.forward(tp, {"tokens": toks}, mode=mode)
    assert got.shape == SHAPE + (tc.padded_vocab(),) and float(aux) == 0.0
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, _tol(dtype))
    last, _ = tm.forward(tp, {"tokens": toks}, mode=mode, last_only=True)
    _close(last, got.float().numpy()[:, -1:], _tol(dtype))


def _state_close(tst, jst, dtype):
    """Every array of the two states: exact where the reference's is
    constant (the reduced config's unused sLSTM slots), else within the
    state tolerance."""
    for name in ("mc", "mn", "mm", "sc", "sn", "sm", "sh"):
        got, want = getattr(tst, name), np.asarray(getattr(jst, name))
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        if np.ptp(want) == 0:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            _close(got, want, FP32_TOL if dtype == "float32" else 2e-2,
                   name)


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(pair, kind, dtype):
    """``prefill`` returns the last logits and the filled state (length
    16, not replayed by ``ServeEngine``): logits against the reference's
    and its ``XLSTMState`` array for array; then 4 ``decode_step``s from
    it against the reference's, and the last against the forward over
    the prompt and the decoded tokens."""
    jc, jm, jp, tc, tm, tp = pair[kind, dtype]
    toks = _tokens(tc, seed=3)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 24)
    tl, tst = tm.prefill(tp, {"tokens": toks}, 24)
    assert tst.length == 16 and int(jst.length) == 16
    _close(tl, jl, _tol(dtype))
    _state_close(tst, jst, dtype)
    nxt = np.random.default_rng(4).integers(0, tc.vocab_size, (2, 4))
    for t in range(4):
        jl, jst = jm.decode(jp, jst, jnp.asarray(nxt[:, t:t + 1]))
        tl, tst = tm.decode(tp, tst, nxt[:, t:t + 1])
        assert tst.length == 17 + t
        _close(tl, jl, _tol(dtype), f"step {t}")
    _state_close(tst, jst, dtype)
    if dtype == "float32":
        # the last step against one prefill of all 20 tokens (chunk 4)
        m4 = build_model(dataclasses.replace(tc, mlstm_chunk=4), "cpu")
        l20, _ = m4.prefill(tp, {"tokens": np.concatenate([toks, nxt], 1)},
                            24)
        _close(tl, l20.numpy(), FP32_TOL, "decode vs prefill of 20")


@pytest.mark.parametrize("kind", list(CFGS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_return_hidden_matches_reference(pair, kind, dtype):
    jc, jm, jp, tc, tm, tp = pair[kind, dtype]
    toks = _tokens(tc, seed=6)
    want = jm.embedding(jp, {"tokens": jnp.asarray(toks)})
    got = tm.embedding(tp, {"tokens": toks})
    assert got.dtype == torch.float32 and got.shape == (2, tc.d_model)
    _close(got, want, FP32_TOL if dtype == "float32" else BF16_TOL)


def test_params_types_and_carry(pair):
    """``slstm/r`` and ``slstm/b`` are held in fp32 whatever the compute
    type, as the reference reads them (a bf16 ``r`` would round the
    recurrence's weights), ``mlstm/bf`` (a vector) too; the other
    matrices in bf16; the doubly stacked ``mlstm/*`` (G, M, ...) paths
    map to ``mlstm.g.m.*`` and back exactly; the reduced config has no
    sLSTM."""
    jc, jm, jp, tc, tm, tp = pair["slstm", "bfloat16"]
    assert {tp.slstm[1].r.dtype, tp.slstm[1].b.dtype,
            tp.mlstm[1][0].bf.dtype} == {torch.float32}
    assert {tp.slstm[0].wx.dtype, tp.slstm[0].wo.dtype,
            tp.mlstm[0][0].wq.dtype, tp.mlstm[0][0].wi.dtype} == \
        {torch.bfloat16}
    tree = jax.tree.map(np.asarray, jp)
    np.testing.assert_array_equal(tp.slstm[1].r.numpy(),
                                  tree["slstm"]["r"][1])
    names = {n for n, _ in tp.named_parameters()}
    want = set()
    for path, d in S.iter_defs(TX.model_defs(tc)):
        lead = d.shape[:S.n_stacked(d)]
        want |= {T.port_name(path, *i) for i in np.ndindex(*lead)}
    assert names == want and "mlstm.1.0.wq" in names
    assert TX.group_shape(tc) == (2, 1)
    f32 = pair["slstm", "float32"][3]
    back = params_to_numpy(f32, params_from_numpy(f32, tree, "cpu"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        np.testing.assert_array_equal(
            S.tree_get(back, "/".join(p.key for p in path)), leaf)
    m = build_model(tc, "cpu")
    assert m.init(0).slstm[0].r.dtype == torch.float32
    assert m.n_params() == jm.n_params()
    red = pair["reduced", "float32"]
    assert red[5].slstm is None and "slstm" not in red[2]
    assert TX.group_shape(red[3]) == (1, 2)


def test_chunk_condition_raises(pair):
    """S must be a multiple of min(chunk, S), as the reference asserts;
    the port raises ``ValueError``."""
    _, _, _, tc, tm_, _ = _layers(pair["slstm", "float32"])
    x = torch.zeros(1, 12, tc.d_model)
    with pytest.raises(ValueError, match="multiple"):
        TX.mlstm_parallel(tc, tm_, x)
    TX.mlstm_parallel(tc, tm_, x[:, :6])          # one chunk of 6
