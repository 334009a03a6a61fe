"""Training the xlstm family in the port against the JAX package on the
CPU: ``Model.loss`` and every gradient leaf against the reference's
``jax.value_and_grad(Model.loss)``, the rounding of the fp32-read
leaves, the sLSTM's autograd Function (``SLSTMScan``) and the
logistic's gradient. The helpers here serve the other families' files:
``test_torch_train_hymba.py``, ``test_torch_train_encdec.py`` (with
remat and ``train()`` refusing enc-dec) and
``test_torch_train_families_step.py`` (the train step, checkpoints and
the launcher).

Configs: reduced xlstm-1.3b at 4 layers with ``slstm_every=2`` (two
groups of 1 mLSTM + 1 sLSTM; the reduced config alone has no sLSTM),
reduced hymba-1.5b with a 4-position window (so the window binds at 16
tokens) and reduced seamless-m4t-medium (2 + 2 layers, 8 frames).
Masters are drawn by the port (``init_masters``) and carried to the
reference (``masters_to_numpy``).

Tolerances (``tests/test_torch_train.py``'s). fp32: the loss within
``FP32_TOL`` (1e-4) relative, each gradient leaf within 1e-4 of its
largest magnitude. bf16 (the configs' own type), against the reference
evaluated op by op (``jax.disable_jit()``): the loss within 2^-12
relative, each leaf within 2^-5 of its largest magnitude; hymba's
within 2^-4 (``BF16_GRAD_TOLS``): its Mamba scan combines in another
tree than ``lax.associative_scan`` and its ``exp`` is torch's, so fp32
states differ in their last bits and flip bf16 roundings of the
branch's output (``tests/test_torch_hymba.py`` holds its bf16 forward
to 2e-2 for the same reason). There both packages' bf16 Mamba
gradients lie 18-79% from the exact gradient of the same bf16 masters,
and the port's up to 4.8% from the reference's.

The init law draws q and k with the head count as fan-in, so attention
is near one-hot and the gradient ill-conditioned: reduced enc-dec's
fp32 gradient lies 2.6e-4 (the reference) and 3.4e-4 (the port) from
the exact (fp64) one, at the largest magnitude, so no two fp32
evaluations are held within 1e-4 of each other there. The fp32 case is
therefore held at the init law and, where the reference itself is not
within 1e-4 of the exact gradient, with q and k tempered to the d_model
fan-in (``tempered``), where both lie within 2e-6 of the exact one; at
the init law each is then held to the exact gradient within 1e-3.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.models import build_model, masters_to_numpy
from repro_torch.models import layers as TL
from repro_torch.models import xlstm as TX
from repro_torch.train.step import loss_and_grads

torch.set_num_threads(1)

FP32_TOL = 1e-4
EXACT_TOL = 1e-3
BF16_LOSS_TOL = 2.0 ** -12
BF16_GRAD_TOL = 2.0 ** -5
BF16_GRAD_TOLS = {"hymba-1.5b": 2.0 ** -4}
SHAPE = (2, 16)
CFGS = {"xlstm-1.3b": dict(num_layers=4, slstm_every=2),
        "hymba-1.5b": dict(window=4),
        "seamless-m4t-medium": {}}


def _cfgs(name, dtype="float32", **kw):
    kw = dict(CFGS.get(name, {}), dtype=dtype, **kw)
    j = dataclasses.replace(jget(name).reduced(), **kw)
    t = dataclasses.replace(get_config(name).reduced(), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out


def _close(got, want, tol, msg=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, msg
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (msg, err, scale)


def tempered(masters):
    """q and k projections (leaves ``.../wq``, ``.../wk``, (..., d_model,
    heads, hd)) scaled by sqrt(heads / d_model): the d_model fan-in."""
    return {k: t * math.sqrt(t.shape[-2] / t.shape[-3])
            if k.rsplit("/", 1)[-1] in ("wq", "wk") else t
            for k, t in masters.items()}


def batch_for(tc, seed, dtype):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, tc.vocab_size, SHAPE).astype(np.int32),
         "labels": rng.integers(0, tc.vocab_size, SHAPE).astype(np.int32)}
    if tc.is_encdec:
        f = rng.normal(size=(SHAPE[0], tc.frontend_tokens, tc.d_model))
        # frames in the compute type, as make_batch gives them
        b["frames"] = torch.from_numpy(f.astype(np.float32)).to(
            getattr(torch, dtype)).float().numpy()
    return b


def jbatch(b, dtype):
    out = {k: jnp.asarray(v) for k, v in b.items()}
    if "frames" in out:
        out["frames"] = out["frames"].astype(jnp.dtype(dtype))
    return out


def port_value_and_grad(tm, masters, batch):
    """The step's cast (every leaf to the compute type), the loss and
    each leaf's gradient in the compute type."""
    p_c = {k: t.detach().to(getattr(torch, tm.cfg.dtype))
           .requires_grad_(True) for k, t in masters.items()}
    loss = tm.loss(p_c, batch)
    return loss.detach(), dict(zip(p_c, torch.autograd.grad(
        loss, list(p_c.values()))))


def ref_value_and_grad(jm, masters, batch, dtype, jitted=None):
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.dtype(dtype)),
                      masters_to_numpy(masters))
    if dtype == "float32":
        jl, jg = jitted(jp, jbatch(batch, dtype))
    else:
        with jax.disable_jit():
            jl, jg = jax.value_and_grad(jm.loss)(jp, jbatch(batch, dtype))
    return float(jl), _flat(jax.tree.map(np.asarray, jg))


def exact_grads(tc, masters, batch):
    m = build_model(dataclasses.replace(tc, dtype="float64"), "cpu")
    return loss_and_grads(m, masters, batch, 1)


def hold_family(name, *, fp32_laws, dtype):
    """Loss and gradients of ``name`` against the reference (see the
    module docstring for the laws and tolerances)."""
    jc, tc = _cfgs(name, dtype)
    jm, tm = jbuild(jc), build_model(tc, "cpu")
    masters = tm.init_masters(3)
    batch = batch_for(tc, 4, dtype)
    laws = {"init": masters, "tempered": tempered(masters)}
    cases = fp32_laws if dtype == "float32" else ("init",)
    jitted = jax.jit(jax.value_and_grad(jm.loss)) \
        if dtype == "float32" else None
    lt, gt = (FP32_TOL, FP32_TOL) if dtype == "float32" else \
        (BF16_LOSS_TOL, BF16_GRAD_TOLS.get(name, BF16_GRAD_TOL))
    for law in cases:
        loss, grads = port_value_and_grad(tm, laws[law], batch)
        jl, jg = ref_value_and_grad(jm, laws[law], batch, dtype, jitted)
        assert loss.dtype == torch.float32
        assert abs(float(loss) - jl) <= lt * abs(jl), (law, float(loss), jl)
        assert sorted(grads) == sorted(jg)
        for k, g in grads.items():
            assert g.dtype == getattr(torch, dtype) and \
                tuple(g.shape) == jg[k].shape, k
            _close(g, jg[k], gt, (law, k))
    return tm, jm, masters, batch, jitted


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_loss_and_grads_match_reference(dtype):
    """Reduced xlstm with sLSTM blocks: at the init law and tempered in
    fp32, at the init law in bf16."""
    hold_family("xlstm-1.3b", fp32_laws=("init", "tempered"), dtype=dtype)


def test_read_as_leaves_round_to_the_compute_type():
    """The train step's cast rounds every float leaf to the compute type,
    the fp32-read ones too (xlstm's ``slstm/r`` and ``slstm/b``, hymba's
    ``a_log``), as the reference's ``_cast_tree`` does; the model then
    reads them as fp32, and their gradients come back in bf16. With
    those leaves kept in fp32 the loss differs."""
    for name, keys, kw in (("xlstm-1.3b", ("slstm/r", "slstm/b"), {}),
                           ("hymba-1.5b", ("win/mamba/a_log",
                                           "glob/mamba/a_log"), {})):
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="bfloat16", **CFGS.get(name, {}),
                                  **kw)
        tm = build_model(cfg, "cpu")
        masters = tm.init_masters(5)
        gen = torch.Generator().manual_seed(6)
        # bits below bf16's in the fp32-read leaves
        for k in keys:
            masters[k] = masters[k] + 1e-3 * torch.randn(
                masters[k].shape, generator=gen)
        batch = batch_for(cfg, 7, "bfloat16")
        seen = {}
        real = tm.loss

        def spy(p, b):
            seen.update(p)
            return real(p, b)
        tm.loss = spy
        loss, grads = loss_and_grads(tm, masters, batch, 1)
        for k in keys:
            assert seen[k].dtype == torch.bfloat16
            assert torch.equal(seen[k].float(),
                               masters[k].to(torch.bfloat16).float())
            assert grads[k].dtype == torch.float32
        lp, g = port_value_and_grad(tm, masters, batch)
        assert torch.equal(lp, loss)
        assert all(g[k].dtype == torch.bfloat16 for k in keys)
        kept = {k: (t.detach().float() if k in keys else
                    t.detach().to(torch.bfloat16))
                for k, t in masters.items()}
        with torch.no_grad():
            assert float(real(kept, batch)) != float(loss)


# ------------------------------------------------------------- SLSTMScan
def _slstm_inputs(b, s, h, hd, dtype, seed, state=False):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=dtype) * scale)
    r = rnd(h, 4 * hd, hd, scale=0.5)
    wx = rnd(b, s, 4, h, hd)
    if state:
        st = (rnd(b, h, hd), rnd(b, h, hd).abs() + 0.5, rnd(b, h, hd),
              rnd(b, h, hd))
    else:
        st = TX.slstm_zero_state(b, h, hd, "cpu", dtype)
    cot = (rnd(b, s, h, hd),) + tuple(rnd(b, h, hd) for _ in range(4))
    return r, wx, st, cot


@pytest.mark.parametrize("state", [False, True])
def test_slstm_scan_function_matches_autograd_in_fp64(state):
    """``SLSTMScan``'s outputs equal ``_scan_eager``'s bit for bit, and
    its gradients (of r, wx and, from a non-zero state, of the initial
    state) equal autograd through ``_scan_eager`` within 1e-12 of each
    tensor's largest magnitude, in fp64, under a random cotangent on
    every output."""
    r, wx, st, cot = _slstm_inputs(3, 12, 2, 8, torch.float64, 0, state)
    ins = [t.clone().requires_grad_(True) for t in (r, wx, *st)]
    ys, *fin = TX.SLSTMScan.apply(*ins, False)
    want_ins = [t.clone().requires_grad_(True) for t in (r, wx, *st)]
    ys2, fin2 = TX._scan_eager(want_ins[0], want_ins[1], tuple(want_ins[2:]))
    assert torch.equal(ys, ys2)
    assert all(torch.equal(a, b) for a, b in zip(fin, fin2))

    def loss(ys, fin):
        return (ys * cot[0]).sum() + sum((a * c).sum()
                                         for a, c in zip(fin, cot[1:]))
    got = torch.autograd.grad(loss(ys, fin), ins)
    want = torch.autograd.grad(loss(ys2, fin2), want_ins)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_slstm_scan_gradcheck():
    """``torch.autograd.gradcheck`` of ``SLSTMScan`` at a tiny size in
    fp64, every input (r, wx and the four state tensors) perturbed."""
    r, wx, st, _ = _slstm_inputs(1, 4, 2, 2, torch.float64, 1, state=True)
    ins = tuple(t.clone().requires_grad_(True) for t in (r, wx, *st))
    assert torch.autograd.gradcheck(
        lambda *a: TX.SLSTMScan.apply(*a, False), ins)


def test_slstm_scan_routes_by_grad_mode(monkeypatch):
    """Where autograd records, ``slstm_scan`` takes ``SLSTMScan`` (not
    graphed on the CPU); without gradients it takes ``_scan_eager``;
    and the two give the same values."""
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(),
                              num_layers=4, slstm_every=2)
    sp = TX.stacked_views(cfg, build_model(cfg, "cpu").init_masters(0)
                          ).slstm[0]
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    taken = []
    real_apply, real_eager = TX.SLSTMScan.apply, TX._scan_eager
    monkeypatch.setattr(TX.SLSTMScan, "apply", lambda *a: (
        taken.append(("function", a[-1])), real_apply(*a))[1])
    monkeypatch.setattr(TX, "_scan_eager", lambda *a: (
        taken.append(("eager",)), real_eager(*a))[1])
    with torch.no_grad():
        y0, _ = TX.slstm_scan(cfg, sp, x)
    y1, _ = TX.slstm_scan(cfg, sp, x.requires_grad_(True))
    assert taken == [("eager",), ("function", False)]
    assert torch.equal(y0, y1.detach())


def test_logistic_gradient_is_finite_where_exp_overflows():
    """``layers.sigmoid`` and ``silu`` take ``lax.logistic``'s derivative:
    finite, and the reference's, where exp(-x) overflows (x < -88 in
    fp32, < -709 in fp64). Autograd through 1 / (1 + exp(-x)) gave NaN
    there, which reached every parameter of a full-width hymba. Against
    the reference within 1e-3 relative: XLA's own logistic loses ~5e-4
    to cancellation near |x| = 10."""
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.float64, None)):
        xs = np.array([-1000.0, -720.0, -100.0, -89.0, -10.0, -0.5, 0.0,
                       0.5, 10.0, 89.0, 100.0, 1000.0])
        for fn, jfn in ((TL.sigmoid, jax.nn.sigmoid),
                        (TL.silu, jax.nn.silu)):
            x = torch.tensor(xs, dtype=dtype, requires_grad=True)
            g, = torch.autograd.grad(fn(x).sum(), x)
            assert bool(torch.isfinite(g).all()), (fn.__name__, dtype, g)
            if jdt is not None:
                want = np.asarray(jax.vmap(jax.grad(jfn))(
                    jnp.asarray(xs, jdt)))
                np.testing.assert_allclose(g.numpy(), want, rtol=1e-3,
                                           atol=0)
