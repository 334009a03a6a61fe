"""The port's model zoo against the JAX package on the CPU: configs,
parameter declaration and init law, the weight carry, and ``forward``, ``prefill`` + ``decode`` and
``pooled_embedding`` of reduced dense and VLM-backbone configs, with the
reference's parameters carried across by ``params_from_numpy``.

Tolerances. fp32 (``dtype="float32"``): logits and embeddings within
1e-4 of their largest magnitude (fp32 summation order, XLA vs torch's
CPU GEMM) and greedy tokens identical. bf16 (the configs' own type):
within 2e-2 of the largest magnitude against the reference as it runs
(XLA fuses the scanned block and drops some intermediate bf16
roundings), and within one bf16 rounding of the largest magnitude
(2^-8) of the reference evaluated op by op (``jax.disable_jit()``),
whose roundings the port reproduces (a product's fp32 sum may still
round the other way now and then).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jall_configs
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import all_configs, get_config
from repro_torch.models import (build_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import spec as S
from repro_torch.models import transformer as T

torch.set_num_threads(1)

FP32_TOL = 1e-4
BF16_TOL = 2e-2
EAGER_TOL = 2.0 ** -8   # one bf16 rounding at the largest magnitude

# (case, config name, head_pad_multiple or None)
CASES = [("llama3-8b", "llama3-8b", None), ("olmo-1b", "olmo-1b", None),
         ("mqrld-embedder-100m", "mqrld-embedder-100m", None),
         ("llama3-8b-padded", "llama3-8b", 8)]


def _cfgs(name, dtype, pad=None):
    """The reduced config from both packages, equal field for field."""
    j, t = jget(name).reduced(), get_config(name).reduced()
    kw = {"dtype": dtype}
    if pad is not None:
        kw["head_pad_multiple"] = pad
    j, t = dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def pair(request):
    """Reference model and parameters, and the port's with the same
    parameters, for one case at fp32 and at bf16."""
    _, name, pad = request.param
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = _cfgs(name, dtype, pad)
        jm = jbuild(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
        out[dtype] = (jc, jm, jp, tc, build_model(tc, "cpu"), tp)
    return out


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


def _tokens(tc, shape=(2, 12), seed=1):
    return np.random.default_rng(seed).integers(
        0, tc.vocab_size, shape).astype(np.int32)


def _greedy(lg, vocab):
    return np.asarray(lg, np.float32)[..., :vocab].argmax(-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(pair, dtype):
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = _tokens(tc)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": toks})
    assert got.shape == (2, 12, tc.padded_vocab()) and float(aux) == 0.0
    if dtype == "float32":
        _close(got, want, FP32_TOL)
        np.testing.assert_array_equal(_greedy(got, tc.vocab_size),
                                      _greedy(want, jc.vocab_size))
    else:
        _close(got, want, BF16_TOL)
        if tc.hp() != tc.num_heads or tc.name == "olmo-1b":
            # padded heads and the non-parametric norm, op by op
            with jax.disable_jit():
                eager, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
            _close(got, eager, EAGER_TOL)
    stream, _ = tm.forward(tp, {"tokens": toks}, mode="stream",
                           last_only=True)
    _close(stream, np.asarray(got.float())[:, -1:],
           FP32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_match_reference(pair, dtype):
    """Prefill (through ``attention_stream``) and three greedy decode
    steps: logits each step and the greedy tokens; the cache holds the
    reference's K/V."""
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = _tokens(tc, seed=2)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    tl, tcache = tm.prefill(tp, {"tokens": toks}, 16)
    assert tcache.length == 12 and tcache.k.shape == tuple(jcache.k.shape)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    _close(tcache.k, jcache.k, tol)
    _close(tcache.v, jcache.v, tol)
    for step in range(3):
        _close(tl, jl, tol)
        nxt = _greedy(jl[:, -1], jc.vocab_size)
        if dtype == "float32":
            np.testing.assert_array_equal(
                _greedy(tl[:, -1], tc.vocab_size), nxt, err_msg=str(step))
        nxt = nxt[:, None].astype(np.int32)
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode(tp, tcache, nxt)
        assert tcache.length == 13 + step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooled_embedding_matches_reference(pair, dtype):
    jc, jm, jp, tc, tm, tp = pair[dtype]
    toks = _tokens(tc, (3, 9), seed=3)
    want = jm.embedding(jp, {"tokens": jnp.asarray(toks)})
    got = tm.embedding(tp, {"tokens": toks})
    assert got.dtype == torch.float32 and got.shape == (3, tc.d_model)
    _close(got, want, FP32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_forward_with_patches_matches_reference(dtype):
    """internvl2-1b's backbone with precomputed patch embeddings
    prepended to the tokens."""
    jc, tc = _cfgs("internvl2-1b", dtype)
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(4))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    toks = _tokens(tc, (2, 6), seed=6)
    patches = rng.normal(size=(2, tc.frontend_tokens, tc.d_model)).astype(
        np.float32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks),
                              "patches": jnp.asarray(patches)})
    got, _ = build_model(tc, "cpu").forward(tp, {"tokens": toks,
                                                 "patches": patches})
    assert got.shape == (2, tc.frontend_tokens + 6, tc.padded_vocab())
    if dtype == "float32":
        _close(got, want, FP32_TOL)
        np.testing.assert_array_equal(_greedy(got, tc.vocab_size),
                                      _greedy(want, jc.vocab_size))
    else:
        _close(got, want, BF16_TOL)


# ------------------------------------------------- configs, defs, weights
def test_configs_match_reference():
    """Every config of the reference is the port's, equal to it full and
    reduced, with the same padded heads and vocabulary."""
    ref = jall_configs()
    assert set(all_configs()) == set(ref)
    for name, cfg in all_configs().items():
        for t, j in ((cfg, ref[name]), (cfg.reduced(), ref[name].reduced())):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert (t.hp(), t.kvp(), t.padded_vocab(), t.hd()) == \
                (j.hp(), j.kvp(), j.padded_vocab(), j.hd())
            assert t.param_count() == j.param_count()
    for name in ("xlstm-1.3b", "seamless-m4t-medium"):
        assert get_config(name) == all_configs()[name]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_defs_and_init_law():
    """The port declares the reference's tree (paths, shapes, init laws)
    and draws it with std = scale / sqrt(shape[-2]) on the stacked
    shape; matrices in the serving type, norm scales fp32."""
    from repro.models.spec import count_params as jcount
    from repro.models.transformer import model_defs as jdefs
    cfg = get_config("mqrld-embedder-100m").reduced()
    jtree = jdefs(jget("mqrld-embedder-100m").reduced())
    jleaves = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: hasattr(x, "logical"))[0]
    want = {"/".join(p.key for p in path): (d.shape, d.init, d.scale)
            for path, d in jleaves}
    defs = dict(S.iter_defs(T.model_defs(cfg)))
    assert {p: (d.shape, d.init, d.scale) for p, d in defs.items()} == want
    assert list(defs) == sorted(want)      # the reference's flatten order
    m = build_model(cfg, "cpu")
    assert m.n_params() == jcount(jtree)
    params = m.init(seed=0)
    flat = {p: t for p, t in zip(
        defs, (S.tree_get(params_to_numpy(cfg, params), p) for p in defs))}
    wq = flat["blocks/attn/wq"]            # (L, d, hp, hd): 1/sqrt(hp)
    assert abs(wq.std() * np.sqrt(wq.shape[-2]) - 1.0) < 0.05
    tok = flat["embed/tok"]                # (V, d): 1/sqrt(V)
    assert abs(tok.std() * np.sqrt(tok.shape[-2]) - 1.0) < 0.05
    np.testing.assert_array_equal(flat["norm_f"], 1.0)
    assert params.blocks[0].attn.wq.dtype == torch.bfloat16
    assert params.blocks[1].norm1.dtype == torch.float32
    # a seed is a seed: the same draw twice, another draw from another
    again = m.init(seed=0)
    assert torch.equal(again.embed.tok, params.embed.tok)
    assert not torch.equal(m.init(seed=1).embed.tok, params.embed.tok)


@pytest.mark.parametrize("name", ["llama3-8b", "olmo-1b", "internvl2-1b"])
def test_weight_carry_round_trip(name):
    """Every reference path maps to one port parameter (blocks/x at layer
    i -> blocks.i.x) and back, exactly; a missing, extra or misshapen
    leaf raises."""
    jc, tc = _cfgs(name, "float32")
    tree = jax.tree.map(np.asarray, jbuild(jc).init(jax.random.PRNGKey(2)))
    params = params_from_numpy(tc, tree, "cpu")
    names = {n for n, _ in params.named_parameters()}
    defs = dict(S.iter_defs(T.model_defs(tc)))
    want = set()
    for path in defs:
        if path.startswith("blocks/"):
            want |= {T.port_name(path, i) for i in range(tc.num_layers)}
        else:
            want.add(T.port_name(path))
    assert names == want
    back = params_to_numpy(tc, params)
    jleaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(jleaves) == len(defs)
    for path, leaf in jleaves:
        np.testing.assert_array_equal(
            S.tree_get(back, "/".join(p.key for p in path)), leaf)
    state = dict(params.named_parameters())
    np.testing.assert_array_equal(state["blocks.1.attn.wq"].numpy(),
                                  tree["blocks"]["attn"]["wq"][1])
    bad = jax.tree.map(lambda x: x, tree)
    bad["blocks"]["attn"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(tc, bad, "cpu")
    del bad["blocks"]["attn"]["extra"], bad["embed"]["tok"]
    with pytest.raises(ValueError, match="embed/tok"):
        params_from_numpy(tc, bad, "cpu")
    bad["embed"]["tok"] = tree["embed"]["tok"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tc, bad, "cpu")


def test_device_rule_and_unported_families():
    """Every family builds on the CPU when asked (xlstm and enc-dec, the
    last two ported, each through its own module) and needs the card
    otherwise."""
    from repro_torch.models import encdec, xlstm
    for name, mod in (("olmo-1b", T), ("xlstm-1.3b", xlstm),
                      ("seamless-m4t-medium", encdec)):
        cfg = get_config(name).reduced()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                build_model(cfg)
        m = build_model(cfg, "cpu")
        assert m.device.type == "cpu" and m.mod is mod
        assert m.init(0).device.type == "cpu"
