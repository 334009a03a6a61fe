"""Training loop: init or restore -> step -> guarded loop -> checkpoints
(port of ``repro/train/loop.py``).

  * resumable by construction: a step's batch is a pure function of the
    step (``data/pipeline.py``), and a checkpoint named N holds the state
    after N steps, the step it resumes at;
  * asynchronous, atomic, integrity-checked checkpoints
    (``checkpoint/checkpointer.py``);
  * non-finite guard: a step whose loss or gradient norm is not finite is
    skipped (the last good params and optimizer state are kept) and
    counted; more than ``max_consecutive_skips`` in a row aborts;
  * SIGTERM/SIGINT end the loop after the current step, and a final
    blocking checkpoint is written.

Two behaviours of the reference that the port does not copy (ROADMAP,
"Reference behaviours the port avoids"): the reference commits a poisoned
step's state, since its donated buffers are gone, where its docstring
promises a skip; and it saves the periodic checkpoint after step s under
the name s, so a resume runs step s a second time. Here a skip keeps the
last good state, and the checkpoint after step s is named s + 1.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import PipelineSpec, SyntheticLM
from repro_torch.models import build_model
from repro_torch.train.optimizer import init_adam
from repro_torch.train.step import make_train_step


@dataclass
class TrainResult:
    steps_run: int
    final_loss: float
    losses: list
    skipped_steps: int
    restored_from: Optional[int]
    # the port's additions: the final fp32 masters and optimizer state
    # (the last good ones), and each step's wall seconds up to the read
    # of its loss (skipped steps included)
    params: Any = None
    opt: Any = None
    step_s: list = field(default_factory=list)


def train(cfg: ModelConfig, tc: TrainConfig, *, seq_len: int = 512,
          data=None, state_dtype: str = "float32", log_every: int = 10,
          log_fn: Callable[[str], None] = print,
          max_consecutive_skips: int = 10, device=None) -> TrainResult:
    """Run up to tc.total_steps of training, resuming from the latest
    checkpoint in tc.checkpoint_dir. ``device=None`` means the CUDA card
    (raises without one); tests pass ``device="cpu"``. The default data
    is ``SyntheticLM``, tokens only: an enc-dec config, whose batches need
    frames, raises here, as the reference's fails at its first step."""
    if cfg.is_encdec and data is None:
        raise ValueError(
            f"{cfg.name}: train() feeds tokens only (SyntheticLM), and an "
            f"enc-dec model needs 'frames' beside them; train it through "
            f"make_train_step on Model.make_batch's batches")
    model = build_model(cfg, device=device)
    step_fn = make_train_step(model, tc, state_dtype=state_dtype)

    if data is None:
        spec = PipelineSpec(vocab_size=cfg.vocab_size, seq_len=seq_len,
                            global_batch=8 * tc.microbatches, seed=tc.seed)
        data = SyntheticLM(spec)

    params = model.init_masters(tc.seed)
    opt = init_adam(params, state_dtype)

    ckpt = Checkpointer(tc.checkpoint_dir)
    start_step = 0
    restored_from = None
    latest = ckpt.latest_step()
    if latest is not None:
        (params, opt), extra = ckpt.restore(latest, (params, opt))
        start_step = int(extra.get("step", latest))
        restored_from = latest
        log_fn(f"[train] restored step {latest}")

    stop = {"now": False}

    def _sig(signum, frame):
        stop["now"] = True
    old_term = signal.signal(signal.SIGTERM, _sig)
    old_int = signal.signal(signal.SIGINT, _sig)

    losses, step_s = [], []
    skipped = 0
    consecutive_skips = 0
    t0 = time.time()
    step = start_step
    try:
        while step < tc.total_steps and not stop["now"]:
            batch = data.batch(step)
            ts = time.perf_counter()
            new_p, new_opt, metrics = step_fn(params, opt, batch)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            step_s.append(time.perf_counter() - ts)
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                # poisoned step: keep the last good params and state
                del new_p, new_opt
                skipped += 1
                consecutive_skips += 1
                log_fn(f"[train] step {step}: non-finite loss/grad, skipping")
                if consecutive_skips > max_consecutive_skips:
                    raise FloatingPointError("too many non-finite steps")
                step += 1
                continue
            consecutive_skips = 0
            params, opt = new_p, new_opt
            losses.append(loss)
            if step % log_every == 0:
                dt = time.time() - t0
                log_fn(f"[train] step {step} loss {loss:.4f} "
                       f"gnorm {gnorm:.2f} ({dt:.1f}s)")
            step += 1
            if tc.checkpoint_every and step % tc.checkpoint_every == 0 \
                    and step < tc.total_steps and not stop["now"]:
                ckpt.save(step, (params, opt), extra={"step": step})
        # final checkpoint (incl. the preemption path)
        ckpt.save(step, (params, opt), extra={"step": step}, block=True)
    finally:
        ckpt.wait()
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
    return TrainResult(steps_run=step - start_step,
                       final_loss=losses[-1] if losses else float("nan"),
                       losses=losses, skipped_steps=skipped,
                       restored_from=restored_from, params=params, opt=opt,
                       step_s=step_s)
