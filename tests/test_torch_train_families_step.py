"""The train step, checkpoints and the launcher for the newly trained
families, on the CPU: ``make_train_step`` on reduced xlstm (with its
sLSTM blocks, through ``SLSTMScan``) against the reference's step at 1
and 2 microbatches; a checkpoint of reduced xlstm crossing between the
packages in both directions; ``launch/train.py --arch`` training hymba
and xlstm. Tolerances: fp32 values within ``FP32_TOL`` (1e-4) of the
largest magnitude of the reference's (``tests/test_torch_train.py``'s).
"""
import json
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

from test_torch_train_families import FP32_TOL, _cfgs, _close, _flat
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train.loop import train as jtrain
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import TrainConfig, get_config
from repro_torch.models import build_model, masters_to_numpy
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train.step import make_train_step

torch.set_num_threads(1)

NAME = "xlstm-1.3b"
SMALL = 1e-3


def _batch(tc, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, tc.vocab_size, (4, 16)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_xlstm_train_step_matches_reference(microbatches):
    """Two fp32 train steps of reduced xlstm with sLSTM blocks: loss,
    gradient norm and moments against the reference's jitted step from
    the same masters on the same batches, within ``FP32_TOL``; the new
    masters too, but for the entries whose first moment lies below
    ``SMALL`` (1e-3) of its leaf's largest after either step: AdamW
    moves an entry by ~lr whatever its gradient's size, and gradients
    that agree within 1e-4 of the leaf's largest agree on such an entry
    only within 10% or worse, so it may land up to 2 lr a step from the
    reference's. Here those are 174 of the sLSTM bias's 512 entries
    (zero at init, so the leaf's scale is lr itself), their gradients
    ~1e-9 of the largest: the rounding noise of the stabiliser m, which
    the loss does not depend on (its gradient cancels to zero in exact
    arithmetic)."""
    jc, tc_model = _cfgs(NAME)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                     microbatches=microbatches)
    jm, tm = jbuild(jc), build_model(tc_model, "cpu")
    tparams = tm.init_masters(8)
    jparams = jax.tree.map(np.asarray, masters_to_numpy(tparams))
    jstep = jax.jit(jmake_train_step(jm, tc))
    tstep = make_train_step(tm, tc)
    jstate, tstate = jopt.init_adam(jparams), topt.init_adam(tparams)
    noise = {k: torch.zeros(t.shape, dtype=torch.bool)
             for k, t in tparams.items()}
    for s in range(2):
        b = _batch(tc_model, 10 + s)
        jparams, jstate, jmet = jstep(jparams, jstate, b)
        tparams, tstate, tmet = tstep(tparams, tstate, b)
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
            FP32_TOL * abs(float(jmet["loss"]))
        _close(tmet["grad_norm"], jmet["grad_norm"], FP32_TOL)
        assert int(tmet["step"]) == int(jmet["step"]) == s + 1
        for k, m in tstate.m.items():
            noise[k] |= m.abs() <= SMALL * float(m.abs().max())
    jflat = _flat(jax.tree.map(np.asarray, jparams))
    for k, t in tparams.items():
        want = torch.from_numpy(np.asarray(jflat[k]))
        err = (t - want).abs()
        held, loose = err[~noise[k]], err[noise[k]]
        assert held.numel() and float(held.max()) <= \
            FP32_TOL * float(want.abs().max()), k
        assert not loose.numel() or \
            float(loose.max()) <= 2 * 2 * tc.learning_rate, k
    for name in ("m", "v"):
        want = _flat(jax.tree.map(np.asarray, getattr(jstate, name)))
        for k, t in getattr(tstate, name).items():
            _close(t, want[k], FP32_TOL, (name, k))


def test_xlstm_checkpoints_cross_between_packages():
    """The reference's ``train()`` on reduced xlstm with sLSTM blocks
    writes a checkpoint at step 4; the port restores it and runs to step
    6 beside the reference from its own step 4; then the other way
    round. Losses and final masters within ``FP32_TOL``; the manifests'
    keys, shapes and dtypes identical (the (G, M, ...) and (G, ...)
    stacked leaves and their moments)."""
    jc, tc_model = _cfgs(NAME)
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
        manifests = []
        for d in (dirs["a"], dirs["c"]):
            with open(os.path.join(d, "step_4", "manifest.json")) as f:
                m = json.load(f)
            manifests.append((m["keys"], m["shapes"], m["dtypes"]))
        assert manifests[0] == manifests[1]
        assert any(k.startswith("[0]/mlstm/") for k in manifests[0][0])
        assert any(k.startswith("[1]/m/slstm/") for k in manifests[0][0])
        shutil.copytree(dirs["a"], dirs["b"])
        shutil.copytree(dirs["c"], dirs["d"])
        t_res = tloop.train(tc_model, tcfg(dirs["b"], 6), device="cpu",
                            **quiet)
        j_res = jtrain(jc, tcfg(dirs["a"], 6), **quiet)
        j_res2 = jtrain(jc, tcfg(dirs["d"], 6), **quiet)
        t_res2 = tloop.train(tc_model, tcfg(dirs["c"], 6), device="cpu",
                             **quiet)
        for t, j, dt, dj in ((t_res, j_res, "b", "a"),
                             (t_res2, j_res2, "c", "d")):
            assert t.restored_from == j.restored_from == 4
            assert t.steps_run == j.steps_run == 2
            np.testing.assert_allclose(t.losses, j.losses, rtol=FP32_TOL)
            mine, _ = Checkpointer(dirs[dt]).restore(6, (t.params, t.opt))
            start = build_model(tc_model, "cpu").init_masters(0)
            theirs, _ = Checkpointer(dirs[dj]).restore(
                6, (start, topt.init_adam(start)))
            for k in mine[0]:
                _close(mine[0][k], theirs[0][k].numpy(), FP32_TOL, k)
            assert int(mine[1].count) == int(theirs[1].count) == 6
            assert JCheckpointer(dirs[dj]).latest_step() == 6
    finally:
        shutil.rmtree(root)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b"])
def test_launcher_trains_the_arch(arch, tmp_path):
    """``launch/train.py --arch`` trains the reduced config on the CPU:
    the steps run, finite, and the final checkpoint holds the family's
    stacked layout."""
    from repro_torch.launch import train as launch
    res = launch.main(["--arch", arch, "--reduced", "--steps", "2",
                       "--seq-len", "16", "--microbatches", "2",
                       "--ckpt", str(tmp_path), "--device", "cpu"])
    assert res.steps_run == 2 and res.skipped_steps == 0
    assert np.isfinite(res.losses).all()
    masters = build_model(get_config(arch).reduced(), "cpu").init_masters(0)
    assert sorted(res.params) == sorted(masters)
    for k, t in res.params.items():
        assert t.shape == masters[k].shape and bool(torch.isfinite(t).all())
    assert Checkpointer(str(tmp_path)).latest_step() == 2
