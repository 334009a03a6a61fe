"""The port's training slice against the JAX package on the CPU:
``TrainConfig``, the optimizer's int8 codes, the data pipeline, the
learning-rate schedule, ``adam_update`` on a stacked tree, the loss and
its gradients on reduced transformer configs (dense, GQA, the
non-parametric norm, MoE with its aux loss, the VLM with patches),
``make_train_step``, remat, the compression helpers, ``model_flops_for``,
the guarded loop and checkpoints that cross between the packages.

Tolerances. fp32: values within ``FP32_TOL`` (1e-4) of the largest
magnitude of the reference's (summation order, XLA vs torch's CPU GEMM);
integers, pipeline batches and int8 codes of equal inputs identical.
bf16 (the configs' own type): against the reference evaluated op by op
(``jax.disable_jit()``), whose roundings the port follows; the loss
within ``BF16_LOSS_TOL`` (2^-12) relative, and each gradient leaf within
``BF16_GRAD_TOL`` (2^-5) of its largest magnitude: a bf16 gradient is
a sum of bf16 products whose rounding order differs between XLA's and
torch's backward (the embedding's scatter-add, the matrix products'
accumulation), and a few elements land one or two bf16 roundings apart.
AdamW after several steps: within ``FP32_TOL`` of each leaf's largest
magnitude; bf16 moments within one bf16 rounding (``BF16_STATE_TOL``,
2^-8) and int8 moments' codes within one code (an fp32 moment an ulp
away can round the other way), their scales within ``FP32_TOL``.
"""
import dataclasses
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget
from repro.data import pipeline as jpipe
from repro.models import build_model as jbuild
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.loop import train as jtrain
from repro.train.step import make_train_step as jmake_train_step
from repro.utils import quant as jquant
from repro.utils.roofline import model_flops_for as jflops
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ALL_SHAPES, TrainConfig, all_configs, \
    get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.models import build_model, masters_from_numpy, \
    masters_to_numpy, params_from_masters
from repro_torch.train import compression as tcomp
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.step import make_train_step
from repro_torch.utils import quant as tquant
from repro_torch.utils.roofline import model_flops_for

torch.set_num_threads(1)

FP32_TOL = 1e-4
BF16_LOSS_TOL = 2.0 ** -12
BF16_GRAD_TOL = 2.0 ** -5
BF16_STATE_TOL = 2.0 ** -8
TOKENS = (4, 16)        # the one token shape of the loss tests


def _cfgs(name, dtype="float32", **kw):
    """The reduced config from both packages, equal field for field."""
    j = dataclasses.replace(jget(name).reduced(), dtype=dtype, **kw)
    t = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out


# ------------------------------------------------------------------ config
def test_train_config_fields():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(JTrainConfig)]


# ------------------------------------------------------------- int8 codes
def test_quantize_i8_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 40)) * 10).astype(np.float32)
    x[1, 2] = 0.0                            # a zero channel: the floor
    x[2, 0, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]   # ties at the channel max
    x[2, 0, 5:] = 0.0
    x[2, 0, 5] = 127.0 * 0.5
    jc, js = jquant.quantize_i8(jnp.asarray(x))
    tc, ts = tquant.quantize_i8(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (3, 5, 1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1, 2, 0]) == np.float32(tquant.SCALE_FLOOR)
    np.testing.assert_array_equal(
        tquant.dequantize_i8(tc, ts).numpy(),
        np.asarray(jquant.dequantize_i8(jc, js)))
    assert tquant.SCALE_FLOOR == jquant.SCALE_FLOOR


# --------------------------------------------------------------- pipeline
@pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (1, 3, 0),
                                            (7, 12, 1), (3, 100, 3)])
def test_pipeline_batches_identical(seed, step, host):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=8, n_hosts=4,
              host_id=host, seed=seed)
    jb = jpipe.SyntheticLM(jpipe.PipelineSpec(**kw)).batch(step)
    tb = tpipe.SyntheticLM(tpipe.PipelineSpec(**kw)).batch(step)
    corpus = np.random.default_rng(seed).integers(0, 1000, 5000)
    jc = jpipe.CorpusLM(jpipe.PipelineSpec(**kw), corpus).batch(step)
    tc = tpipe.CorpusLM(tpipe.PipelineSpec(**kw), corpus).batch(step)
    for want, got in ((jb, tb), (jc, tc)):
        assert sorted(got) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    st = tpipe.PipelineState(step=step, seed=seed)
    assert tpipe.PipelineState.from_dict(st.to_dict()) == st
    assert st.to_dict() == jpipe.PipelineState(step=step,
                                               seed=seed).to_dict()


# ---------------------------------------------------------------- schedule
def test_lr_schedule_matches_reference():
    tc = TrainConfig(learning_rate=3e-4, warmup_steps=10, total_steps=50)
    steps = np.arange(0, 60, dtype=np.float32)
    want = np.asarray(jopt.lr_schedule(tc, jnp.asarray(steps)))
    got = topt.lr_schedule(tc, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    _close(got, want, FP32_TOL)
    # warmup is linear, the end holds a tenth of the peak
    assert float(got[5]) == pytest.approx(1.5e-4, rel=1e-6)
    assert float(got[55]) == pytest.approx(3e-5, rel=1e-5)


# ---------------------------------------------------------------- AdamW
@pytest.fixture(scope="module")
def stacked():
    """The reduced embedder's masters (blocks stacked: a norm scale is
    (L, d), ``norm_f`` (d,)) and three steps' gradients."""
    jc, tc = _cfgs("mqrld-embedder-100m")
    jp = _np_tree(jbuild(jc).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32) * 0.05, jp) for _ in range(3)]
    return tc, jp, grads


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adam_update_matches_reference(stacked, state_dtype):
    tc_model, jp, grads = stacked
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    jparams, jstate = jp, jopt.init_adam(jp, state_dtype)
    tparams = masters_from_numpy(tc_model, jp, "cpu")
    tstate = topt.init_adam(tparams, state_dtype)
    for g in grads:
        jparams, jstate, jn = jopt.adam_update(
            tc, jparams, jax.tree.map(jnp.asarray, g), jstate, state_dtype)
        tparams, tstate, tn = topt.adam_update(
            tc, tparams, masters_from_numpy(tc_model, g, "cpu"), tstate,
            state_dtype)
        _close(tn, jn, FP32_TOL)
    assert int(tstate.count) == int(jstate.count) == 3
    jflat = _flat(_np_tree(jparams))
    for k, t in tparams.items():
        assert t.dtype == torch.float32
        _close(t, jflat[k], FP32_TOL)
    for name in ("m", "v"):
        want = _flat(_np_tree(getattr(jstate, name)))
        for k, enc in getattr(tstate, name).items():
            if isinstance(want[k], tuple):
                codes, scale = enc
                assert codes.dtype == torch.int8 and \
                    tuple(scale.shape) == codes.shape[:-1] + (1,)
                assert np.abs(codes.numpy().astype(int)
                              - want[k][0].astype(int)).max() <= 1
                _close(scale, want[k][1], FP32_TOL)
            else:
                assert not isinstance(enc, tuple)
                assert str(enc.dtype).replace("torch.", "") == \
                    str(want[k].dtype)
                # a bf16 moment is one rounding of an fp32 one that may
                # lie an ulp away
                _close(enc, want[k], BF16_STATE_TOL
                       if state_dtype == "bfloat16" else FP32_TOL)
    # the stacked rules: a block's norm scale (L, d) is decayed and, in
    # int8, coded; norm_f (d,) is neither
    is_int8 = state_dtype == "int8"
    assert isinstance(tstate.m["blocks/norm1"], tuple) == is_int8
    assert not isinstance(tstate.m["norm_f"], tuple)
    assert tstate.m["norm_f"].dtype == (torch.float32 if is_int8 else
                                        topt.torch_dtype(state_dtype))


def test_weight_decay_on_stacked_shapes(stacked):
    """With zero gradients only the decay moves a parameter: the stacked
    norm scales (L, d) shrink by lr * wd, ``norm_f`` (d,) stays."""
    tc_model, jp, _ = stacked
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=10)
    params = masters_from_numpy(tc_model, jp, "cpu")
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    new, _, gnorm = topt.adam_update(tc, params, zeros,
                                     topt.init_adam(params))
    assert float(gnorm) == 0.0
    lr = float(topt.lr_schedule(tc, torch.tensor(1.0)))
    want = params["blocks/norm1"] - lr * (0.1 * params["blocks/norm1"])
    torch.testing.assert_close(new["blocks/norm1"], want, rtol=0, atol=0)
    assert torch.equal(new["norm_f"], params["norm_f"])


def test_adam_abstract(stacked):
    tc_model, jp, _ = stacked
    params = masters_from_numpy(tc_model, jp, "cpu")
    for sd in ("float32", "bfloat16", "int8"):
        ab = topt.adam_abstract(params, sd)
        real = topt.init_adam(params, sd)
        for k, enc in real.m.items():
            spec = ab.m[k]
            pairs = zip(spec, enc) if isinstance(enc, tuple) else \
                [(spec, enc)]
            for s, t in pairs:
                assert s.shape == tuple(t.shape) and s.dtype == t.dtype
        assert ab.count.shape == () and ab.count.dtype == torch.int32


def test_state_carried_across(stacked):
    """The reference's int8 state (codes, scales tuples) carried to the
    port and back, array for array."""
    _, jp, grads = stacked
    tc = TrainConfig(warmup_steps=1)
    _, st, _ = jopt.adam_update(tc, jp, jax.tree.map(jnp.asarray, grads[0]),
                                jopt.init_adam(jp, "int8"), "int8")
    st = jax.tree.map(np.asarray, st)
    port = topt.state_from_numpy(st.m, st.v, st.count, "cpu")
    back = topt.state_to_numpy(port)
    assert int(back["count"]) == 1
    for name in ("m", "v"):
        want = _flat(getattr(st, name))
        got = _flat(back[name])
        assert sorted(want) == sorted(got)
        for k in want:
            assert isinstance(got[k], tuple) == isinstance(want[k], tuple)
            pairs = zip(want[k], got[k]) if isinstance(want[k], tuple) \
                else [(want[k], got[k])]
            for a, b in pairs:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_masters_carry_and_serving_params(stacked):
    """The reference's tree as fp32 masters and back, array for array;
    ``params_from_masters`` of ``init_masters(s)`` is ``init(s)``, the
    serving module in its serving types."""
    tc_model, jp, _ = stacked
    masters = masters_from_numpy(tc_model, jp, "cpu")
    assert all(t.dtype == torch.float32 for t in masters.values())
    back = _flat(masters_to_numpy(masters))
    want = _flat(jp)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    _, bf = _cfgs("mqrld-embedder-100m", "bfloat16")
    tm = build_model(bf, "cpu")
    a = dict(params_from_masters(bf, tm.init_masters(3)).named_parameters())
    b = dict(tm.init(3).named_parameters())
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ------------------------------------------------------- loss and gradients
GRAD_CASES = ["mqrld-embedder-100m", "llama3-8b", "olmo-1b",
              "phi3.5-moe-42b-a6.6b", "internvl2-1b"]


def _batch(tc, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, tc.vocab_size, TOKENS).astype(np.int32),
         "labels": rng.integers(0, tc.vocab_size, TOKENS).astype(np.int32)}
    if tc.frontend == "vit_stub":
        p = rng.normal(size=(TOKENS[0], tc.frontend_tokens, tc.d_model))
        # patches in the compute type, as the reference's inputs are
        dt = torch.bfloat16 if tc.dtype == "bfloat16" else torch.float32
        b["patches"] = torch.from_numpy(p.astype(np.float32)).to(
            dt).float().numpy()
    return b


def _jbatch(b, dtype):
    out = {k: jnp.asarray(v) for k, v in b.items()}
    if "patches" in out:
        out["patches"] = out["patches"].astype(dtype)
    return out


def _port_value_and_grad(tm, masters, batch):
    p_c = {k: t.detach().to(topt.torch_dtype(tm.cfg.dtype))
           .requires_grad_(True) for k, t in masters.items()}
    loss = tm.loss(p_c, batch)
    grads = torch.autograd.grad(loss, list(p_c.values()))
    return loss.detach(), dict(zip(p_c, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", GRAD_CASES)
def test_loss_and_grads_match_reference(name, dtype):
    jc, tc = _cfgs(name, dtype)
    jm, tm = jbuild(jc), build_model(tc, "cpu")
    jp = _np_tree(jm.init(jax.random.PRNGKey(3)))
    batch = _batch(tc, 4)
    masters = masters_from_numpy(tc, jp, "cpu")
    loss, grads = _port_value_and_grad(tm, masters, batch)
    jp_c = jax.tree.map(lambda a: jnp.asarray(a, jnp.dtype(dtype)), jp)
    if dtype == "float32":
        jl, jg = jax.value_and_grad(jm.loss)(jp_c, _jbatch(batch, dtype))
        lt = gt = FP32_TOL
    else:
        with jax.disable_jit():
            jl, jg = jax.value_and_grad(jm.loss)(jp_c,
                                                 _jbatch(batch, dtype))
        lt, gt = BF16_LOSS_TOL, BF16_GRAD_TOL
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jl)) <= lt * abs(float(jl))
    jg = _flat(_np_tree(jg))
    assert sorted(grads) == sorted(jg)
    for k, g in grads.items():
        assert g.dtype == topt.torch_dtype(dtype) and \
            tuple(g.shape) == jg[k].shape
        _close(g, np.asarray(jg[k], np.float32), gt)


def test_moe_aux_in_loss():
    """phi3.5-moe's loss holds 0.01 x the aux loss of the forward."""
    _, tc = _cfgs("phi3.5-moe-42b-a6.6b")
    tm = build_model(tc, "cpu")
    masters = tm.init_masters(0)
    batch = _batch(tc, 5)
    logits, aux = tm.forward(params_from_masters(tc, masters), batch)
    from repro_torch.models import cross_entropy
    ce = cross_entropy(logits, torch.from_numpy(batch["labels"]),
                       valid_vocab=tc.vocab_size)
    assert float(aux) > 0
    with torch.no_grad():
        loss = tm.loss(masters, batch)
    assert abs(float(loss) - float(ce + 0.01 * aux)) <= 1e-6 * float(loss)


def test_cross_entropy_masks_padded_vocab():
    from repro.models.zoo import cross_entropy as jce
    from repro_torch.models import cross_entropy
    rng = np.random.default_rng(6)
    lg = rng.normal(size=(2, 5, 512)).astype(np.float32) * 3
    lab = rng.integers(0, 300, (2, 5)).astype(np.int32)
    want = jce(jnp.asarray(lg), jnp.asarray(lab), valid_vocab=300)
    got = cross_entropy(torch.from_numpy(lg), torch.from_numpy(lab),
                        valid_vocab=300)
    _close(got, want, FP32_TOL)


@pytest.mark.parametrize("mode", ["block", "group"])
def test_remat_changes_memory_not_values(mode):
    """Block and group remat (``torch.utils.checkpoint`` around one or
    ``remat_group`` blocks) give gradients identical to no remat."""
    kw = dict(num_layers=4)
    kw.update(remat="block") if mode == "block" else \
        kw.update(remat="none", remat_group=2)
    _, plain = _cfgs("mqrld-embedder-100m", "bfloat16", num_layers=4)
    _, rem = _cfgs("mqrld-embedder-100m", "bfloat16", **kw)
    masters = build_model(plain, "cpu").init_masters(2)
    batch = _batch(plain, 7)
    from torch.utils import checkpoint as ckpt_mod
    calls = []
    real = ckpt_mod.checkpoint

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    import repro_torch.models.transformer as T
    l0, g0 = _port_value_and_grad(build_model(plain, "cpu"), masters, batch)
    T.checkpoint = counting
    try:
        l1, g1 = _port_value_and_grad(build_model(rem, "cpu"), masters,
                                      batch)
    finally:
        T.checkpoint = real
    assert len(calls) == (4 if mode == "block" else 2)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_input_specs_and_make_batch():
    from repro.configs.base import TRAIN_4K as JTRAIN
    from repro_torch.configs.base import TRAIN_4K
    for name in ("mqrld-embedder-100m", "internvl2-1b",
                 "seamless-m4t-medium"):
        jc, tc = _cfgs(name, "bfloat16")
        sh = dataclasses.replace(TRAIN_4K, seq_len=24, global_batch=2)
        jsh = dataclasses.replace(JTRAIN, seq_len=24, global_batch=2)
        want = jbuild(jc).input_specs(jsh)
        tm = build_model(tc, "cpu")
        got = tm.input_specs(sh)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape
            assert str(got[k].dtype).replace("torch.", "") == \
                str(want[k].dtype)
        b = tm.make_batch(sh, 0)
        for k, t in b.items():
            assert tuple(t.shape) == got[k].shape and t.dtype == got[k].dtype
            if t.dtype == torch.int32:
                assert 0 <= int(t.min()) and int(t.max()) < tc.vocab_size


# ------------------------------------------------------------- train step
@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, state_dtype):
    """Two train steps in fp32: loss, grad norm, new masters and moments
    against the reference's step on the same batch and masters."""
    jc, tc_model = _cfgs("mqrld-embedder-100m")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                     microbatches=microbatches)
    jm, tm = jbuild(jc), build_model(tc_model, "cpu")
    jp = _np_tree(jm.init(jax.random.PRNGKey(8)))
    jstep = jax.jit(jmake_train_step(jm, tc, state_dtype))
    tstep = make_train_step(tm, tc, state_dtype)
    jparams, jstate = jp, jopt.init_adam(jp, state_dtype)
    tparams = masters_from_numpy(tc_model, jp, "cpu")
    tstate = topt.init_adam(tparams, state_dtype)
    for s in range(2):
        b = _batch(tc_model, 10 + s)
        jparams, jstate, jmet = jstep(jparams, jstate, _jbatch(b, "float32"))
        tparams, tstate, tmet = tstep(tparams, tstate, b)
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
            FP32_TOL * abs(float(jmet["loss"]))
        _close(tmet["grad_norm"], jmet["grad_norm"], FP32_TOL)
        assert int(tmet["step"]) == int(jmet["step"]) == s + 1
    jflat = _flat(_np_tree(jparams))
    for k, t in tparams.items():
        _close(t, jflat[k], FP32_TOL)
    jm_flat = _flat(_np_tree(jstate.m))
    for k, enc in tstate.m.items():
        if isinstance(enc, tuple):
            _close(tquant.dequantize_i8(*enc),
                   jquant.dequantize_i8(*map(jnp.asarray, jm_flat[k])),
                   2 * FP32_TOL + 1 / 127)
        else:
            _close(enc, jm_flat[k], FP32_TOL)


def test_train_step_accumulates_in_fp32():
    """Two microbatches: the step's gradient is the fp32 mean of the two
    bf16 microbatch gradients, and the inputs are left unchanged."""
    _, tc_model = _cfgs("mqrld-embedder-100m", "bfloat16")
    tm = build_model(tc_model, "cpu")
    masters = tm.init_masters(1)
    b = _batch(tc_model, 12)
    halves = [{k: v[:2] for k, v in b.items()}, {k: v[2:] for k, v in
                                                 b.items()}]
    gs = [_port_value_and_grad(tm, masters, h)[1] for h in halves]
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, microbatches=2,
                     grad_clip=1e9)
    captured = {}
    real = topt.adam_update

    def spy(tc_, params, grads, state, sd):
        captured.update(grads)
        return real(tc_, params, grads, state, sd)
    import repro_torch.train.step as step_mod
    step_mod.adam_update = spy
    try:
        before = {k: v.clone() for k, v in masters.items()}
        make_train_step(tm, tc)(masters, topt.init_adam(masters), b)
    finally:
        step_mod.adam_update = real
    for k in masters:
        assert torch.equal(masters[k], before[k])
        want = (torch.zeros_like(masters[k]) + gs[0][k].float()
                + gs[1][k].float()) / 2
        assert captured[k].dtype == torch.float32
        assert torch.equal(captured[k], want), k


# ------------------------------------------------------------ compression
def test_compression_helpers_match_reference():
    rng = np.random.default_rng(9)
    g = rng.normal(size=(6, 33)).astype(np.float32)
    g[2] = 0.0
    err = (rng.normal(size=(6, 33)) * 1e-3).astype(np.float32)
    jc, js = jcomp.quantize_grad(jnp.asarray(g))
    tc, ts = tcomp.quantize_grad(torch.from_numpy(g))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcomp.dequantize_grad(tc, ts).numpy(),
                                  np.asarray(jcomp.dequantize_grad(jc, js)))
    want = jcomp.compress_residual(jnp.asarray(g), jnp.asarray(err))
    got = tcomp.compress_residual(torch.from_numpy(g), torch.from_numpy(err))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # error feedback: the mean of what was sent tends to g
    e = torch.zeros(64)
    gv = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    sent = torch.zeros(64)
    for _ in range(20):
        c, s, e = tcomp.compress_residual(gv, e)
        sent += tcomp.dequantize_grad(c, s)
    assert float((sent / 20 - gv).abs().max()) <= float(gv.abs().max()) / 100
    tree = tcomp.init_error_tree({"a": torch.ones(2, 3),
                                  "b": {"c": torch.ones(4)}})
    assert tree["a"].shape == (2, 3) and float(tree["b"]["c"].sum()) == 0


# --------------------------------------------------------------- roofline
def test_model_flops_for_matches_reference():
    from repro.configs import all_configs as jall
    from repro.configs.base import ALL_SHAPES as JSHAPES
    jcfgs = jall()
    for name, cfg in all_configs().items():
        for sh, jsh in zip(ALL_SHAPES, JSHAPES):
            assert model_flops_for(cfg, sh) == jflops(jcfgs[name], jsh)


# ------------------------------------------------------------------- loop
def test_train_loss_decreases_and_resumes():
    """The reference's loop test, on the port."""
    cfg = get_config("mqrld-embedder-100m").reduced()
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(total_steps=10, checkpoint_every=4,
                         checkpoint_dir=d, microbatches=2,
                         learning_rate=1e-3, warmup_steps=2)
        res = tloop.train(cfg, tc, seq_len=32, log_every=100,
                          log_fn=lambda s: None, device="cpu")
        assert res.steps_run == 10
        assert res.final_loss < res.losses[0]
        assert res.skipped_steps == 0
        assert Checkpointer(d).all_steps() == [4, 8, 10]
        d4 = os.path.join(d, "from4")
        shutil.copytree(os.path.join(d, "step_4"),
                        os.path.join(d4, "step_4"))
        tc2 = dataclasses.replace(tc, total_steps=14)
        res2 = tloop.train(cfg, tc2, seq_len=32, log_every=100,
                           log_fn=lambda s: None, device="cpu")
        assert res2.restored_from == 10
        assert res2.steps_run == 4
        # checkpoint N holds the state after N steps: resuming at step 4
        # reruns steps 4..9 of the first run exactly
        res3 = tloop.train(cfg, dataclasses.replace(tc, checkpoint_dir=d4),
                           seq_len=32, log_every=100,
                           log_fn=lambda s: None, device="cpu")
        assert res3.restored_from == 4 and int(res3.opt.count) == 10
        assert res3.losses == res.losses[4:]
        for k, t in res3.params.items():
            assert torch.equal(t, res.params[k]), k


def test_train_requires_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mqrld-embedder-100m").reduced()
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="CUDA"):
            tloop.train(cfg, TrainConfig(total_steps=1, checkpoint_dir=d),
                        seq_len=8, log_fn=lambda s: None)
        from repro_torch.launch import train as launch
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.main(["--reduced", "--steps", "1", "--ckpt", d])
        res = launch.main(["--reduced", "--steps", "2", "--seq-len", "8",
                           "--ckpt", d, "--device", "cpu"])
        assert res.steps_run == 2


def _poisoning(monkeypatch, bad_steps):
    """Wrap the loop's train step: at the calls in ``bad_steps`` it
    returns NaN masters and a NaN loss. Records (params in, params out)
    of every call."""
    calls = []
    real = tloop.make_train_step

    def make(model, tc, state_dtype="float32"):
        step = real(model, tc, state_dtype)

        def poisoned(params, opt, batch):
            new_p, new_opt, met = step(params, opt, batch)
            if len(calls) in bad_steps:
                new_p = {k: v * float("nan") for k, v in new_p.items()}
                met = dict(met, loss=torch.tensor(float("nan")))
            calls.append((params, opt, new_p, new_opt))
            return new_p, new_opt, met
        return poisoned
    monkeypatch.setattr(tloop, "make_train_step", make)
    return calls


def test_poisoned_step_keeps_last_good_state(monkeypatch):
    calls = _poisoning(monkeypatch, {2, 3})
    cfg = get_config("mqrld-embedder-100m").reduced()
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(total_steps=6, checkpoint_every=0, checkpoint_dir=d,
                         warmup_steps=1)
        res = tloop.train(cfg, tc, seq_len=16, log_fn=lambda s: None,
                          device="cpu")
    assert res.skipped_steps == 2 and len(res.losses) == 4
    # steps 2 and 3 were skipped: step 4 starts from step 1's output
    good_p, good_opt = calls[1][2], calls[1][3]
    for i in (2, 3, 4):
        assert calls[i][0] is good_p and calls[i][1] is good_opt
    assert int(calls[4][1].count) == 2 and int(res.opt.count) == 4
    assert all(torch.isfinite(t).all() for t in res.params.values())


def test_too_many_poisoned_steps_abort(monkeypatch):
    _poisoning(monkeypatch, set(range(100)))
    cfg = get_config("mqrld-embedder-100m").reduced()
    with tempfile.TemporaryDirectory() as d:
        tc = TrainConfig(total_steps=20, checkpoint_dir=d)
        with pytest.raises(FloatingPointError):
            tloop.train(cfg, tc, seq_len=16, log_fn=lambda s: None,
                        max_consecutive_skips=3, device="cpu")


# ------------------------------------------------------------ checkpoints
def test_checkpoint_roundtrip_integrity_and_gc():
    tree = ({"a": torch.arange(12.0).reshape(3, 4),
             "n": {"b": torch.ones((2, 2), dtype=torch.bfloat16)}},
            topt.init_adam({"w": torch.ones(3, 4), "b": torch.ones(4)},
                           "int8"))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        for s in (5, 10, 15):
            ck.save(s, tree, extra={"step": s}, block=True)
        assert ck.all_steps() == [10, 15]
        back, extra = ck.restore(15, tree)
        assert extra["step"] == 15
        assert torch.equal(back[0]["a"], tree[0]["a"])
        assert back[0]["n"]["b"].dtype == torch.bfloat16
        assert isinstance(back[1], topt.AdamState)
        assert back[1].m["w"][0].dtype == torch.int8
        assert tuple(back[1].m["w"][1].shape) == (3, 1)
        # the reference reads the port's file (bf16 as its raw words)
        jtree = ({"a": jnp.zeros((3, 4)), "n": {"b": jnp.zeros((2, 2),
                                                                jnp.bfloat16)}},
                 jopt.init_adam({"w": jnp.ones((3, 4)), "b": jnp.ones(4)},
                                "int8"))
        jback, _ = JCheckpointer(d).restore(15, jtree)
        np.testing.assert_array_equal(jback[0]["a"], tree[0]["a"].numpy())
        # corruption is detected
        path = os.path.join(d, "step_15", "arrays_0.npz")
        z = dict(np.load(path).items())
        z["[0]__a"] = z["[0]__a"] + 1
        np.savez(path, **z)
        with pytest.raises(ValueError, match="corrupt"):
            ck.restore(15, tree)


def _manifest(d, step):
    import json
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        m = json.load(f)
    return m["keys"], m["shapes"], m["dtypes"]


def test_checkpoints_cross_between_packages():
    """The reference writes a checkpoint at step 4 of a reduced-embedder
    ``train()`` (fp32 compute); the port restores it and runs to step 8,
    beside the reference from its own step 4. Then the other way round.
    Losses and final masters agree within ``FP32_TOL``; the manifests'
    keys, shapes and dtypes are identical."""
    jc, tc_model = _cfgs("mqrld-embedder-100m")
    quiet = dict(seq_len=16, log_every=100, log_fn=lambda s: None)
    root = tempfile.mkdtemp()
    try:
        dirs = {k: os.path.join(root, k) for k in "abcd"}

        def tcfg(d, steps):
            return TrainConfig(total_steps=steps, checkpoint_every=0,
                               checkpoint_dir=d, microbatches=2,
                               learning_rate=1e-3, warmup_steps=2)
        jtrain(jc, tcfg(dirs["a"], 4), **quiet)
        tloop.train(tc_model, tcfg(dirs["c"], 4), device="cpu", **quiet)
        assert _manifest(dirs["a"], 4) == _manifest(dirs["c"], 4)
        shutil.copytree(dirs["a"], dirs["b"])
        shutil.copytree(dirs["c"], dirs["d"])
        # reference checkpoint -> port, beside the reference
        t_res = tloop.train(tc_model, tcfg(dirs["b"], 8), device="cpu",
                            **quiet)
        j_res = jtrain(jc, tcfg(dirs["a"], 8), **quiet)
        # port checkpoint -> reference, beside the port
        j_res2 = jtrain(jc, tcfg(dirs["d"], 8), **quiet)
        t_res2 = tloop.train(tc_model, tcfg(dirs["c"], 8), device="cpu",
                             **quiet)
        for t, j, dt, dj in ((t_res, j_res, "b", "a"),
                             (t_res2, j_res2, "c", "d")):
            assert t.restored_from == j.restored_from == 4
            assert t.steps_run == j.steps_run == 4
            np.testing.assert_allclose(t.losses, j.losses, rtol=FP32_TOL)
            mine, _ = Checkpointer(dirs[dt]).restore(
                8, (t.params, t.opt))
            want = JCheckpointer(dirs[dj])
            jp = build_model(tc_model, "cpu").init_masters(0)
            jstate = topt.init_adam(jp)
            theirs, _ = Checkpointer(dirs[dj]).restore(8, (jp, jstate))
            for k in mine[0]:
                _close(mine[0][k], theirs[0][k].numpy(), FP32_TOL)
            assert int(mine[1].count) == int(theirs[1].count) == 8
            assert want.latest_step() == 8
    finally:
        shutil.rmtree(root)
