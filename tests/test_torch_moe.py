"""The port's MoE layer and MoE transformers against the JAX package on
the CPU: ``moe`` alone (routing, output, aux loss), with forced drops and
with tied gate logits, then ``forward`` with the aux loss, ``prefill`` +
``decode`` and the pooled embedding of reduced phi3.5-moe and arctic (its
dense residual branch), the reference's parameters carried across by
``params_from_numpy``.

The reference's ``moe`` returns no routing, so ``_ref_routing`` evaluates
its routing lines (``repro/models/moe.py:45-59``: gate logits, softmax,
``lax.top_k``, the exclusive-cumsum slots and the capacity test) in JAX
on the same inputs. ``chip_smoke.moe_onehot`` is the reference's
one-hot formulation written in plain torch (the card run holds ``moe``
to it): its routing must be the reference's, and the port's index
dispatch must equal its output, bit for bit in bf16 and within 1e-6 of
the scale in fp32.

Tolerances. fp32: ``topk_i``, slot and keep identical; outputs and
logits within 1e-4 of their largest magnitude, the aux loss within 1e-5.
bf16 (the configs' own type): the layer alone within 2e-2 of its largest
magnitude, and wherever a token's choices differ from the reference's,
the two experts' gate logits lie within one bf16 unit of each other (the
products round to bf16 before the softmax, so a different summation
order can swap two experts that close). The models' logits in bf16 are
held to the reference evaluated op by op (``jax.disable_jit()``), whose
roundings the port reproduces, within one bf16 rounding of the largest
magnitude (2^-8; within 2e-2 a fortiori): the reference as it runs
compiles the scanned block, drops some intermediate bf16 roundings, and
lies up to ~3% of the largest logit from its own op-by-op result on
these inputs.
"""
import contextlib
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

FP32_TOL = 1e-4
AUX_TOL = 1e-5
BF16_TOL = 2e-2
EAGER_TOL = 2.0 ** -8   # one bf16 rounding at the largest magnitude
NAMES = ["phi3.5-moe-42b-a6.6b", "arctic-480b"]
DTYPES = ["float32", "bfloat16"]


def _cfgs(name, dtype):
    j = dataclasses.replace(jget(name).reduced(), dtype=dtype)
    t = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """Reference model and parameters, and the port's with the same
    parameters, at fp32 and bf16."""
    out = {}
    for dtype in DTYPES:
        jc, tc = _cfgs(request.param, dtype)
        jm = jbuild(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
        out[dtype] = (jc, jm, jp, tc, build_model(tc, "cpu"), tp)
    return out


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(
        np.abs(want).max())


def _ref_routing(jc, jl, x, capacity_factor=1.25):
    """``repro/models/moe.py``'s routing, evaluated as it is written."""
    b, s, _ = x.shape
    e, k = jc.num_experts, jc.top_k
    cap = int(max(k, capacity_factor * k * s / e))
    gate = jnp.einsum("bsd,de->bse", x,
                      jl["router"].astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(gate, axis=-1)
    _, topk_i = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(topk_i, e, dtype=jnp.int32)
    flat = onehot.reshape(b, s * k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(b, s, k, e)
    slot = jnp.sum(pos * onehot, axis=-1)
    keep = jnp.sum((pos < cap) & (onehot > 0), axis=-1) > 0
    return (np.asarray(gate), np.asarray(topk_i), np.asarray(slot),
            np.asarray(keep), cap)


def _onehot():
    """``chip_smoke.moe_onehot``: the reference's one-hot dispatch and
    combine in plain torch, with its own routing (the repository root's
    script, which the card run holds ``moe`` to as well)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.moe_onehot


def _ref_run(dtype):
    """The reference as it runs in fp32; op by op in bf16."""
    return jax.disable_jit() if dtype == "bfloat16" else \
        contextlib.nullcontext()


def _tol(dtype):
    return FP32_TOL if dtype == "float32" else EAGER_TOL


def _layer(pair_dtype):
    jc, _, jp, tc, _, tp = pair_dtype
    return jc, jax.tree.map(lambda a: a[0], jp["blocks"]["moe"]), tc, \
        tp.blocks[0].moe


def _both(x, dtype):
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _routing_differences(gate, want_i, got_i):
    """Every place where the port chose another expert than the reference:
    the two experts' reference gate logits must lie within one bf16 unit
    at their magnitude. Returns how many there were."""
    diff = np.argwhere(want_i != got_i)
    for b, s, j in diff:
        a, c = gate[b, s, want_i[b, s, j]], gate[b, s, got_i[b, s, j]]
        unit = 2.0 ** (np.floor(np.log2(max(abs(a), abs(c)))) - 7)
        assert abs(a - c) <= unit, (b, s, j, a, c)
    return len(diff)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_layer_matches_reference(pair, dtype):
    jc, jl, tc, tl = _layer(pair[dtype])
    x = np.random.default_rng(1).normal(size=(2, 12, tc.d_model)).astype(
        np.float32)
    jx, tx = _both(x, dtype)
    want, jaux = jmoe.moe(jc, jl, jx)
    got, taux = tmoe.moe(tc, tl, tx)
    gate, ti, tslot, tkeep, cap = _ref_routing(jc, jl, jx)
    r = tmoe.route(tc, tl, tx)
    assert r.cap == cap and got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_array_equal(r.topk_i.numpy(), ti)
        np.testing.assert_array_equal(r.slot.numpy(), tslot)
        np.testing.assert_array_equal(r.keep.numpy(), tkeep)
        _close(got, want, FP32_TOL)
    else:
        if _routing_differences(gate, ti, r.topk_i.numpy()) == 0:
            np.testing.assert_array_equal(r.slot.numpy(), tslot)
            np.testing.assert_array_equal(r.keep.numpy(), tkeep)
        _close(got, want, BF16_TOL)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    # the one-hot form routes as the reference does, and the index
    # dispatch equals it: bit for bit in bf16 (a product of two bf16
    # values is exact in fp32); in fp32 within 1e-6 of the scale (a fused
    # multiply-add in the one-hot einsum skips one product's rounding)
    oh, oi, oslot, okeep = _onehot()(torch, tc, tl, tx)
    np.testing.assert_array_equal(oi.numpy(), r.topk_i.numpy())
    np.testing.assert_array_equal(oslot.numpy(), r.slot.numpy())
    np.testing.assert_array_equal(okeep.numpy(), r.keep.numpy())
    _close(got, oh.float().numpy(), 1e-6 if dtype == "float32" else 0.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_forced_drops_match_reference(pair, dtype):
    """Every token the same: each one's two choices go to the same two
    experts, 12 per row against a capacity of 7, so the last 5 of each
    are dropped; the port drops the same ones and its output is the
    reference's."""
    jc, jl, tc, tl = _layer(pair[dtype])
    row = np.random.default_rng(2).normal(size=tc.d_model)
    x = np.broadcast_to(row, (2, 12, tc.d_model)).astype(np.float32)
    jx, tx = _both(x, dtype)
    _, ti, tslot, tkeep, cap = _ref_routing(jc, jl, jx)
    r = tmoe.route(tc, tl, tx)
    assert cap == 7 and int((~tkeep).sum()) == 2 * 2 * 5
    np.testing.assert_array_equal(r.topk_i.numpy(), ti)
    np.testing.assert_array_equal(r.slot.numpy(), tslot)
    np.testing.assert_array_equal(r.keep.numpy(), tkeep)
    want, jaux = jmoe.moe(jc, jl, jx)
    got, taux = tmoe.moe(tc, tl, tx)
    _close(got, want, FP32_TOL if dtype == "float32" else BF16_TOL)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    # a dropped choice adds nothing: a token with both choices dropped
    # keeps only arctic's dense branch
    dropped = ~r.keep.numpy().any(-1)
    assert dropped.any()
    dense = (tmoe.L.mlp(tl.dense, tx) if tc.dense_residual_ff
             else torch.zeros_like(tx))
    b, s = np.argwhere(dropped)[0]
    torch.testing.assert_close(got[b, s], dense[b, s], rtol=0, atol=0)


def test_moe_tied_gate_logits_keep_the_lower_expert():
    """Equal probabilities order by expert, as ``lax.top_k`` does: zero
    tokens tie every expert (choices 0 and 1), and two equal router
    columns tie their experts on every token; ``torch.topk`` promises
    nothing on ties, the port's stable sort does."""
    for name in NAMES:
        jc, tc = _cfgs(name, "float32")
        jl = jax.tree.map(lambda a: np.array(a[0]), jbuild(jc).init(
            jax.random.PRNGKey(3))["blocks"]["moe"])
        jl["router"][:, 2] = jl["router"][:, 1]
        tree = {"router": jl["router"], "w_gate": jl["w_gate"],
                "w_up": jl["w_up"], "w_down": jl["w_down"]}
        if "dense" in jl:
            tree["dense"] = dict(jl["dense"])
        from repro_torch.models.transformer import Group
        tl = Group(jax.tree.map(torch.from_numpy, tree))
        x = np.random.default_rng(4).normal(size=(2, 12, tc.d_model))
        x[:, :3] = 0.0
        x = x.astype(np.float32)
        jx, tx = _both(x, "float32")
        gate, ti, tslot, tkeep, _ = _ref_routing(jc, jl, jx)
        r = tmoe.route(tc, tl, tx)
        np.testing.assert_array_equal(r.topk_i.numpy(), ti)
        np.testing.assert_array_equal(r.slot.numpy(), tslot)
        np.testing.assert_array_equal(r.keep.numpy(), tkeep)
        assert (ti[:, :3] == [0, 1]).all()
        assert (gate[..., 1] == gate[..., 2]).all()
        # the tie decides: experts 1 and 2 both among the choices, in order
        both = (ti == 1).any(-1) & (ti == 2).any(-1)
        assert both.any()
        pos1 = np.argmax(ti == 1, -1)
        pos2 = np.argmax(ti == 2, -1)
        assert (pos1[both] < pos2[both]).all()
        want, _ = jmoe.moe(jc, jl, jx)
        got, _ = tmoe.moe(tc, tl, tx)
        _close(got, want, FP32_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_with_aux_matches_reference(pair, dtype):
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, (2, 12))
    with _ref_run(dtype):
        want, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, taux = tm.forward(tp, {"tokens": toks})
    assert got.shape == (2, 12, tc.padded_vocab())
    assert float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    _close(got, want, _tol(dtype))
    if dtype == "float32":
        np.testing.assert_array_equal(
            got.numpy()[..., :tc.vocab_size].argmax(-1),
            np.asarray(want)[..., :jc.vocab_size].argmax(-1))
    stream, saux = tm.forward(tp, {"tokens": toks}, mode="stream",
                              last_only=True)
    _close(stream, np.asarray(got.float())[:, -1:], _tol(dtype))
    assert float(saux) == float(taux)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_decode_match_reference(pair, dtype):
    """Prefill (its MoE capacity counted over the prompt) and three
    greedy decode steps (capacity k per row), logits each step; the
    cache holds the reference's K/V."""
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, (2, 12))
    with _ref_run(dtype):
        jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    tl, tcache = tm.prefill(tp, {"tokens": toks}, 16)
    tol = _tol(dtype)
    assert tcache.length == 12
    _close(tcache.k, jcache.k, tol)
    _close(tcache.v, jcache.v, tol)
    for step in range(3):
        _close(tl, jl, tol)
        nxt = np.asarray(jl, np.float32)[:, -1, :jc.vocab_size].argmax(-1)
        if dtype == "float32":
            np.testing.assert_array_equal(
                tl.numpy()[:, -1, :tc.vocab_size].argmax(-1), nxt)
        nxt = nxt[:, None].astype(np.int32)
        with _ref_run(dtype):
            jl, jcache = jm.decode(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode(tp, tcache, nxt)
        assert tcache.length == 13 + step


@pytest.mark.parametrize("dtype", DTYPES)
def test_pooled_embedding_matches_reference(pair, dtype):
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (3, 9))
    with _ref_run(dtype):
        want = jm.embedding(jp, {"tokens": jnp.asarray(toks)})
    got = tm.embedding(tp, {"tokens": toks})
    assert got.dtype == torch.float32 and got.shape == (3, tc.d_model)
    _close(got, want, _tol(dtype))


def test_moe_params_and_capacity():
    """The nested ``moe/dense`` paths carry both ways; every expert
    matrix and the router are held in the compute type; the capacity is
    counted per batch row from the sequence length."""
    from repro_torch.models import params_to_numpy
    jc, tc = _cfgs("arctic-480b", "bfloat16")
    tree = jax.tree.map(np.asarray, jbuild(jc).init(jax.random.PRNGKey(8)))
    tp = params_from_numpy(tc, tree, "cpu")
    names = {n for n, _ in tp.named_parameters()}
    assert "blocks.1.moe.dense.w_up" in names
    assert "blocks.0.moe.router" in names and "blocks.0.mlp.w_up" \
        not in names
    m = tp.blocks[1].moe
    assert {m.router.dtype, m.w_gate.dtype, m.dense.w_down.dtype} == \
        {torch.bfloat16}
    back = params_to_numpy(tc, tp)
    np.testing.assert_array_equal(
        back["blocks"]["moe"]["dense"]["w_up"],
        torch.tensor(tree["blocks"]["moe"]["dense"]["w_up"]).bfloat16()
        .float().numpy())
    full = get_config("arctic-480b")
    assert tmoe.capacity(full, 1000) == 19
    assert tmoe.capacity(full, 1) == 2
    assert tmoe.capacity(get_config("phi3.5-moe-42b-a6.6b"), 2048) == 320
