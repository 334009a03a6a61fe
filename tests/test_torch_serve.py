"""The port's serving engine on the CPU: ``ServeEngine``'s batching
contract (the port of tests/test_serve.py's mixed-length parity and
no-phantom-rows cases, dense, MoE, hybrid, xlstm and enc-dec configs),
its tokens against the reference's ``ServeEngine`` on the same weights
(dense, xlstm, enc-dec), and ``EmbeddingServer`` against the
reference's.

Tolerance: tokens identical; embeddings within 1e-4 of their largest
magnitude at fp32 (fp32 summation order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.serve.engine import EmbeddingServer as JEmbeddingServer
from repro.serve.engine import GenRequest as JGenRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.serve.engine import EmbeddingServer, GenRequest, ServeEngine

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["olmo-1b", "llama3-8b",
                                  "phi3.5-moe-42b-a6.6b", "arctic-480b",
                                  "hymba-1.5b", "xlstm-1.3b",
                                  "seamless-m4t-medium"])
def test_mixed_length_batch_parity(name):
    """Batched generation over mixed-length prompts is token-identical to
    per-request generation (length-bucketed padding-free batches). MoE
    capacity counts per batch row, so equal-length rows route as they
    would alone; hymba's and enc-dec's caches are filled by replaying the
    prompt; xlstm's prompts are whole chunks (8) or shorter, as its
    chunked form requires."""
    cfg = get_config(name).reduced()
    eng = ServeEngine(cfg, device="cpu", max_len=48, batch_size=4, seed=0)
    rng = np.random.default_rng(7)
    lens = (5, 16, 7, 16) if name == "xlstm-1.3b" else (5, 9, 7, 9)
    reqs = [GenRequest(rng.integers(1, cfg.vocab_size // 2, size=n)
                       .astype(np.int32), 5)
            for n in lens]
    batched = eng.generate(reqs)
    assert len(batched) == len(reqs)
    for i, r in enumerate(reqs):
        solo = eng.generate([r])[0]
        np.testing.assert_array_equal(batched[i].tokens, solo.tokens,
                                      err_msg=f"request {i}")


def test_no_phantom_rows_in_short_batch():
    """A final chunk smaller than batch_size runs at its true size (no
    zero-padded phantom rows) and returns one result per request."""
    cfg = get_config("olmo-1b").reduced()
    eng = ServeEngine(cfg, device="cpu", max_len=32, batch_size=8, seed=0)
    seen = []
    prefill = eng.model.prefill
    eng.model.prefill = lambda p, b, n: seen.append(
        tuple(b["tokens"].shape)) or prefill(p, b, n)
    reqs = [GenRequest(np.arange(1, 7, dtype=np.int32), 4),
            GenRequest(np.arange(2, 8, dtype=np.int32), 4)]
    res = eng.generate(reqs)
    assert seen == [(2, 6)]
    assert len(res) == 2
    for r in res:
        assert r.tokens.shape == (4,)
        assert r.prefill_s >= 0 and r.decode_s >= 0


def test_tokens_match_reference_engine():
    """At fp32, the port's ServeEngine generates the reference engine's
    tokens from the same weights, over mixed lengths and max_new."""
    jc = dataclasses.replace(jget("llama3-8b").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("llama3-8b").reduced(),
                             dtype="float32")
    jeng = JServeEngine(jc, max_len=40, batch_size=2, seed=3)
    teng = ServeEngine(tc, params_from_numpy(
        tc, jax.tree.map(np.asarray, jeng.params), "cpu"), device="cpu",
        max_len=40, batch_size=2)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32)
               for n in (6, 11, 6, 6)]
    news = (6, 4, 3, 6)
    want = jeng.generate([JGenRequest(p, m) for p, m in zip(prompts, news)])
    got = teng.generate([GenRequest(p, m) for p, m in zip(prompts, news)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


@pytest.mark.parametrize("name,kw,lens", [
    ("xlstm-1.3b", dict(num_layers=4, slstm_every=2), (6, 16, 6, 8)),
    ("seamless-m4t-medium", {}, (6, 11, 6, 6))])
def test_recurrent_and_encdec_tokens_match_reference_engine(name, kw, lens):
    """xlstm (with sLSTM blocks: its prefill's filled state, no replay)
    and enc-dec (zero frames, the prompt replayed through decode) at
    fp32: the port's ServeEngine generates the reference engine's tokens
    from the same weights, over mixed lengths and max_new."""
    jc = dataclasses.replace(jget(name).reduced(), dtype="float32", **kw)
    tc = dataclasses.replace(get_config(name).reduced(), dtype="float32",
                             **kw)
    jeng = JServeEngine(jc, max_len=40, batch_size=2, seed=3)
    teng = ServeEngine(tc, params_from_numpy(
        tc, jax.tree.map(np.asarray, jeng.params), "cpu"), device="cpu",
        max_len=40, batch_size=2)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in lens]
    news = (6, 4, 3, 6)
    want = jeng.generate([JGenRequest(p, m) for p, m in zip(prompts, news)])
    got = teng.generate([GenRequest(p, m) for p, m in zip(prompts, news)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_embedding_server_matches_reference():
    jc = dataclasses.replace(jget("mqrld-embedder-100m").reduced(),
                             dtype="float32")
    tc = dataclasses.replace(get_config("mqrld-embedder-100m").reduced(),
                             dtype="float32")
    jsrv = JEmbeddingServer(jc, seed=1)
    tsrv = EmbeddingServer(tc, params_from_numpy(
        tc, jax.tree.map(np.asarray, jsrv.params), "cpu"), device="cpu")
    toks = np.random.default_rng(12).integers(0, 200, (4, 10))
    want = jsrv.embed(toks)
    got = tsrv.embed(toks)
    assert got.shape == (4, tc.d_model) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_engines_take_the_card_by_default():
    cfg = get_config("olmo-1b").reduced()
    for cls in (ServeEngine, EmbeddingServer):
        if torch.cuda.is_available():
            assert cls(cfg).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                cls(cfg)
        assert cls(cfg, device="cpu").params.device.type == "cpu"
