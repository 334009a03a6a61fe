"""MQRLD on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors the JAX reference's module layout (``core/`` for the
platform, ``kernels/`` for the hand-written Hopper kernels and their
plain PyTorch versions, ``csrc/`` for the CUDA sources). It imports
``torch``, numpy and the standard library only.

Device rule: every entry point takes an explicit ``device``; ``None``
means the CUDA card and raises when there is none. A tensor on the CPU
takes a kernel's plain version, a CUDA tensor takes the kernel.
"""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); anything else is
    taken as given, so tests pass ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


def op_counter():
    """The op counter (``utils/opcount.Counter``) counting on this thread,
    or None. It is looked up on torch's dispatch-mode stack, which is the
    thread's own and which autograd carries into the threads that run a
    counted step's backward; code on any other thread never sees it."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in _get_current_dispatch_mode_stack():
        if getattr(mode, "is_op_counter", False):
            return mode
    return None


def counted(fn):
    """``fn`` as written, except while the op counter counts on this
    thread: then the counter's stand-in for ``fn.__name__`` runs, if it
    has one (a kernel charged by its law, a loop's step weighted by its
    trips). Marks the kernel entry points and the sequential loops."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        counter = op_counter()
        if counter is None:
            return fn(*args, **kwargs)
        return counter.stand_in(fn, args, kwargs)
    return call


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's route where the models have two (the
    flash kernel in ``attention_stream``, a captured CUDA graph for the
    sLSTM scan and a decode step): a CUDA tensor does, and so does any
    tensor of the op counter's fake trace on this thread, so a trace on
    the CPU takes the card's routes."""
    if t.is_cuda:
        return True
    counter = op_counter()
    return counter is not None and counter.fake
