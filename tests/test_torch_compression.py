"""The compressed cross-pod train step (``train/compression.py``) over an
in-process pod axis (``sharding.pod_mesh``), on the CPU, against the
reference's arithmetic and the port's plain step.

The reference's step runs inside a ``shard_map`` manual over "pod",
which needs a mesh of P devices; its pod exchange is ``_pod_sync``:
``compress_residual`` of (g + err) on each pod, an int32 ``psum`` of
the int8 codes, a ``psum`` of the scales, and the decode
``summed * (scale_sum / n) / n``. Here that arithmetic is composed in
numpy over P = 2 pods from the reference's own ``compress_residual`` and
held to the port bit for bit. The whole step is held to the port's
plain ``make_train_step`` on the same batch by the reference's own
bounds (``tests/test_system.py``): the losses within 0.05, every
parameter within 1e-2.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jcomp
from repro_torch.configs import TrainConfig, get_config
from repro_torch.models import build_model
from repro_torch.sharding import PodMesh, pod_mesh
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep_mod
from repro_torch.train.step import loss_and_grads, make_train_step

torch.set_num_threads(1)

LOSS_TOL, PARAM_TOL = 0.05, 1e-2


def _ref_pod_sync(gs, errs):
    """The reference's ``_pod_sync`` over stacked pods, composed in
    numpy: (codes, scales, residuals per pod, the decoded mean)."""
    parts = [tuple(np.asarray(a) for a in jcomp.compress_residual(
        jnp.asarray(g), jnp.asarray(e))) for g, e in zip(gs, errs)]
    codes = [p[0] for p in parts]
    scales = [p[1] for p in parts]
    summed = np.sum([c.astype(np.int32) for c in codes], axis=0,
                    dtype=np.int32)
    scale_sum = scales[0]
    for s in scales[1:]:
        scale_sum = scale_sum + s
    n = np.float32(len(gs))
    mean = summed.astype(np.float32) * (scale_sum / n) / n
    return codes, scales, [p[2] for p in parts], mean


@pytest.mark.parametrize("with_err", [False, True])
def test_pod_sync_equals_the_reference_arithmetic(with_err):
    """``pod_sync`` over ``pod_mesh(2)``: each pod's codes and scales
    (``compress_residual``), its new residual and the decoded mean equal
    the reference's arithmetic bit for bit; from zero residuals (step 1)
    and from carried ones."""
    rng = np.random.default_rng(0)
    mesh = pod_mesh(2, "cpu")
    for shape in ((6, 33), (4,), (2, 3, 40)):
        gs = (rng.normal(size=(2,) + shape) * 0.1).astype(np.float32)
        gs[1, ..., :2] = 0.0                  # a zero channel's floor
        errs = (rng.normal(size=gs.shape) * 1e-3).astype(np.float32) \
            if with_err else np.zeros_like(gs)
        codes, scales, res, mean = _ref_pod_sync(gs, errs)
        for i in range(2):
            c, s, r = tcomp.compress_residual(torch.from_numpy(gs[i]),
                                              torch.from_numpy(errs[i]))
            np.testing.assert_array_equal(c.numpy(), codes[i])
            np.testing.assert_array_equal(s.numpy(), scales[i])
            np.testing.assert_array_equal(r.numpy(), res[i])
        got, new_err = tcomp.pod_sync(mesh, torch.from_numpy(gs),
                                      torch.from_numpy(errs))
        assert got.dtype == torch.float32 and got.shape == shape
        np.testing.assert_array_equal(got.numpy(), mean)
        np.testing.assert_array_equal(new_err.numpy(), np.stack(res))


def test_pod_mesh_collectives():
    """``psum`` keeps int32 codes in int32 (no widening), ``pmean``
    divides the sum by P, ``split`` gives P contiguous row shards, and P
    below 1 or rows that do not divide raise."""
    mesh = pod_mesh(3, "cpu")
    assert isinstance(mesh, PodMesh) and mesh.pods == 3
    codes = torch.tensor([[127, -127], [127, 1], [127, 0]],
                         dtype=torch.int32)
    s = mesh.psum(codes)
    assert s.dtype == torch.int32 and s.tolist() == [381, -126]
    x = torch.tensor([1.0, 2.0, 4.0])
    assert float(mesh.pmean(x)) == np.float32(7.0) / np.float32(3.0)
    rows = torch.arange(12).reshape(6, 2)
    parts = mesh.split(rows)
    assert parts.shape == (3, 2, 2) and torch.equal(parts[1], rows[2:4])
    with pytest.raises(ValueError):
        mesh.split(torch.zeros(4, 2))
    with pytest.raises(ValueError):
        pod_mesh(0, "cpu")
    err = tcomp.init_error_tree({"w": torch.ones(2, 3)}, mesh)
    assert err["w"].shape == (3, 2, 3) and float(err["w"].abs().sum()) == 0


@pytest.fixture(scope="module")
def olmo():
    """Reduced olmo-1b (the reference's own compressed-step test's model)
    in fp32, its masters and a 16-row batch."""
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                              dtype="float32")
    model = build_model(cfg, "cpu")
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (16, 8)).astype(np.int32)
             for k in ("tokens", "labels")}
    return model, model.init_masters(0), batch


def _spy_adam(monkeypatch):
    """Record the gradients each ``adam_update`` of the compressed step
    receives."""
    seen = []
    real = tcomp.adam_update

    def spy(tc, params, grads, state, sd="float32", gnorm=None):
        seen.append({k: g.clone() for k, g in grads.items()})
        return real(tc, params, grads, state, sd, gnorm)
    monkeypatch.setattr(tcomp, "adam_update", spy)
    return seen


def test_compressed_step_matches_plain_step(olmo, monkeypatch):
    """At P = 2 (one microbatch per pod): the loss within 0.05 of the plain
    step's and every parameter within 1e-2, the reference's bounds; the
    update's gradient is the reference's ``_pod_sync`` of the two pods'
    gradients (each ``loss_and_grads`` on its 8 contiguous rows), bit for
    bit; the loss is the pods' mean; the residuals come back per pod."""
    model, masters, batch = olmo
    tc = TrainConfig(microbatches=1, learning_rate=1e-3, warmup_steps=1)
    mesh = pod_mesh(2, "cpu")
    opt = topt.init_adam(masters)
    p1, _, m1 = make_train_step(model, tc)(masters, opt, batch)
    seen = _spy_adam(monkeypatch)
    err = tcomp.init_error_tree(masters, mesh)
    p2, o2, e2, m2 = tcomp.make_compressed_train_step(model, tc, mesh)(
        masters, opt, err, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < LOSS_TOL
    assert max(float((p1[k] - p2[k]).abs().max()) for k in p1) < PARAM_TOL
    shards = [{k: v[i * 8:(i + 1) * 8] for k, v in batch.items()}
              for i in range(2)]
    pods = [loss_and_grads(model, masters, b, 1) for b in shards]
    want_loss = (pods[0][0] + pods[1][0]) / torch.tensor(2.0)
    assert torch.equal(m2["loss"], want_loss.float())
    for k in masters:
        gs = np.stack([p[1][k].numpy() for p in pods])
        _, _, res, mean = _ref_pod_sync(gs, np.zeros_like(gs))
        np.testing.assert_array_equal(seen[0][k].numpy(), mean)
        np.testing.assert_array_equal(e2[k].numpy(), np.stack(res))
    assert int(o2.count) == 1 and int(m2["step"]) == 1


def test_error_buffers_carry_across_steps(olmo, monkeypatch):
    """Three compressed steps at P = 2 with two microbatches a pod: each
    pod's residual is its own (the pods' differ), and each step's update
    decodes (g + the residual the step before left) on each pod; the
    losses are finite."""
    model, masters, batch = olmo
    tc = TrainConfig(microbatches=2, learning_rate=1e-3, warmup_steps=1)
    mesh = pod_mesh(2, "cpu")
    step = tcomp.make_compressed_train_step(model, tc, mesh)
    grads_seen = []
    real = tcomp.loss_and_grads

    def spy(m, params, b, n):
        out = real(m, params, b, n)
        grads_seen.append(out[1])
        return out
    monkeypatch.setattr(tcomp, "loss_and_grads", spy)
    seen = _spy_adam(monkeypatch)
    params, opt = masters, topt.init_adam(masters)
    err = tcomp.init_error_tree(masters, mesh)
    losses = []
    for s in range(3):
        before = err
        params, opt, err, met = step(params, opt, err, batch)
        losses.append(float(met["loss"]))
        for k in masters:
            gs = np.stack([grads_seen[2 * s + i][k].numpy()
                           for i in range(2)])
            _, _, res, mean = _ref_pod_sync(gs, before[k].numpy())
            np.testing.assert_array_equal(seen[s][k].numpy(), mean)
            np.testing.assert_array_equal(err[k].numpy(), np.stack(res))
    assert np.isfinite(losses).all()
    assert all(not torch.equal(e[0], e[1]) for e in err.values())
    assert all(float(e.abs().max()) > 0 for e in err.values())


def test_one_pod_is_the_plain_step_on_decoded_gradients(olmo):
    """``pod_mesh(1)``: the loss is the plain step's bit for bit, and the
    new masters and state are AdamW's on the decoded int8 codes of the
    plain step's gradient (``dequantize(quantize(g))``), bit for bit."""
    model, masters, batch = olmo
    tc = TrainConfig(microbatches=2, learning_rate=1e-3, warmup_steps=1)
    mesh = pod_mesh(1, "cpu")
    opt = topt.init_adam(masters)
    _, _, m1 = make_train_step(model, tc)(masters, opt, batch)
    p2, o2, e2, m2 = tcomp.make_compressed_train_step(model, tc, mesh)(
        masters, opt, tcomp.init_error_tree(masters, mesh), batch)
    assert torch.equal(m1["loss"], m2["loss"])
    _, g = tstep_mod.loss_and_grads(model, masters, batch, 2)
    decoded = {k: tcomp.dequantize_grad(*tcomp.quantize_grad(t))
               for k, t in g.items()}
    want_p, want_o, _ = topt.adam_update(tc, masters, decoded, opt)
    for k in masters:
        assert torch.equal(p2[k], want_p[k]), k
        assert torch.equal(o2.m[k], want_o.m[k]), k
        assert torch.equal(e2[k][0], g[k] - decoded[k]), k
