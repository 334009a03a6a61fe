"""CUDA graphs for the models' sequential loops, and ``scan``, the loop
over chunks whose steps the op counter weights by their number.

A decode step, or one step of a recurrence, is a few thousand small
kernels whose launches hold the card idle most of the time. Captured
once as a CUDA graph and replayed, the same kernels run without the
host's launch cost. Nothing a captured function does may read a value
back to the host, so positions enter as device tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

import repro_torch
from repro_torch import counted


@counted
def scan(step: Callable, carry: Tuple[torch.Tensor, ...],
         xs: Tuple[torch.Tensor, ...], dim: int = 1):
    """``lax.scan`` over index ``j`` of dimension ``dim`` of every tensor
    of ``xs``: ``carry = step(*carry, *(x.select(dim, j) for x in xs))``
    for each j in turn. Returns (the last carry, the list of the carries
    entering each step). The op counter (``utils/opcount.py``) runs one
    step and weights it by the number of steps."""
    seen = []
    for j in range(xs[0].shape[dim]):
        seen.append(carry)
        carry = step(*carry, *(x.select(dim, j) for x in xs))
    return carry, seen


@counted
def capture(fn: Callable[[], Any], device: torch.device):
    """Runs ``fn()`` once on a side stream (the real call, and the
    warm-up a capture needs), then captures it as a CUDA graph. Returns
    (the first call's result, the graph, the graph's result: the tensor
    each replay writes)."""
    current = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        first = fn()
    current.wait_stream(stream)
    if first is not None:
        first.record_stream(current)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        out = fn()
    return first, graph, out


class StepGraph:
    """``step(tokens, idx)`` (one decode step on one cache's tensors,
    written in place, returning the logits) captured for one set of
    parameters; the tokens and the position enter through two tensors of
    its own. Built by the cache's first step, which runs for real before
    the capture; every later step replays it."""

    def __init__(self, step: Callable, params, tokens: torch.Tensor,
                 idx: int):
        self.params = params
        self.tokens = tokens.clone()
        self.idx = torch.full((), idx, dtype=torch.int64,
                              device=tokens.device)
        self.first, self.graph, self.logits = capture(
            lambda: step(self.tokens, self.idx), tokens.device)

    def run(self, tokens: torch.Tensor, idx: int) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.idx.fill_(idx)
        self.graph.replay()
        return self.logits.clone()


def decode(step: Callable, params, graph: Optional[StepGraph],
           tokens: torch.Tensor, idx: int
           ) -> Tuple[torch.Tensor, Optional[StepGraph]]:
    """One decode step at position ``idx``: ``step(tokens, idx tensor)``
    as it is on the CPU; on the card through ``graph`` (the cache's),
    captured by this step if the cache has none for ``params``. Returns
    (logits, the cache's graph)."""
    if not repro_torch.on_card(tokens):
        return step(tokens, torch.tensor(idx)), graph
    if graph is None or graph.params is not params:
        graph = StepGraph(step, params, tokens, idx)
        return graph.first, graph
    return graph.run(tokens, idx), graph
