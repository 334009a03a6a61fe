"""The work laws reproduce the bounds PERF.md gives at its shapes, and
the embedder's operation count agrees with torch's own count of the
reference forward."""
import math

import pytest
import torch

from perfbench import spec
from perfbench.laws import embedder

LAWS = spec.found("laws/kernels", [spec.PKG])


def test_pairwise_bound_at_dpc_shape():
    s, by = LAWS["pairwise_sq_l2"].bound(4096, 200_000, 512)
    assert by == "operations"
    assert round(s * 1e3, 2) == 12.52


def test_topk_masked_bound_at_straggler_round():
    g, c, d, k = 256, 1024, 512, 28
    s, by = LAWS["topk_l2_masked"].bound(g, c, d, k, needed=g * c,
                                          lb2=False)
    assert by == "bytes"
    assert round(s * 1e3, 3) == 0.161


def test_quant_lb2_bound_at_widest_int8_round():
    # chip_smoke's operands: 80% of candidates valid, none of the last
    # tile's final 24 rows (every query holds all 512 tiles), query 0
    # all masked and query 2 cut to 100 candidates
    g, c, d = 256, 32768, 512
    nvalid = round(0.8 * ((g - 2) * (c - 24) + 100))
    s, by = LAWS["quant_lb2"].bound(g, c, d, nvalid, "int8")
    assert by == "bytes"
    assert round(s * 1e3, 3) == 1.053


def test_needed_candidates_only_lower_the_bound():
    full = LAWS["topk_l2_masked"].bound(64, 512, 256, 20, 64 * 512, True)[0]
    some = LAWS["topk_l2_masked"].bound(64, 512, 256, 20, 64 * 100, True)[0]
    assert some < full


@pytest.mark.parametrize("b,s", [(1, 16), (3, 32)])
def test_embedder_flops_match_counted_products(b, s):
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench import inputs
    from perfbench.reference import embedder as ref
    model = dict(name="x", num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=4, d_ff=96, vocab_size=128,
                 rope_theta=10000.0)
    w = {k: v.float() for k, v in
         inputs.embedder_weights(model, 3, "cpu").items()}
    tokens = torch.randint(0, 128, (b, s))
    with FlopCounterMode(display=False) as fc:
        ref.pooled(w, tokens, model)
    d, n = model["d_model"], model["num_layers"]
    # the reference scores every pair; the law counts causal pairs only
    uncounted = n * b * 4 * d * (s * s - s * (s + 1) / 2)
    assert math.isclose(embedder.forward_flops(model, b, s),
                        fc.get_total_flops() - uncounted, rel_tol=1e-12)


def test_every_law_names_an_entry_point_and_a_launch_counter():
    import importlib

    from repro_torch.kernels import ops
    assert set(LAWS) == {"pairwise_sq_l2", "topk_l2_masked", "quant_lb2"}
    for name, law in LAWS.items():
        assert callable(getattr(ops, law.ENTRY)), name
        module, attr = law.COUNTER
        assert isinstance(getattr(importlib.import_module(
            "repro_torch.kernels." + module), attr), int), name
        assert law.SYMBOL
