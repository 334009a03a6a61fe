"""Operation counter: the work of a step, counted while it runs (the
port's counterpart of ``repro/utils/hlo.py``).

The reference compiles each dry-run cell and parses XLA's SPMD HLO for
trip-count-aware FLOPs, HBM bytes and collective bytes. The port has no
compiler and no HLO to parse, so this module is not named ``hlo``: it
counts the aten operations a step dispatches, under a
``TorchDispatchMode``, as the step runs. ``count_ops(fake=True)`` runs
the step on fake tensors (``torch._subclasses.FakeTensorMode``: shapes,
types and devices, no storage), so a full-size cell counts on the CPU
without allocating anything; ``count_ops(fake=False)`` counts a live run
on the card's tensors, which gives the same totals.

What it counts, per operation:

- FLOPs of ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and ``convolution``:
  2 * prod(result) * prod(contracting dims), ``hlo._dot_flops``'s law.
  Nothing else carries FLOPs, as in the reference.
- HBM bytes: each input read once and each output written once. Views
  and metadata operations move nothing (``hlo._FREE_OPS``), nor does an
  allocation (``empty``); a broadcast (stride-0) dimension is read once.
  A gather (``index``, ``index_select``, ``gather``, ``embedding``)
  reads the rows it returns, or its whole source where that is smaller
  (a repeating gather, such as the kv heads' expansion); an indexed
  update (``index_put_``, ``index_copy_``, ``index_add_``, ``scatter``)
  writes only its update, as ``hlo.py`` charges a dynamic-update-slice
  its slice; ``copy_`` and ``fill_`` write their target without reading
  it.
- Kernels by their own law. Where a step reaches one of the port's
  kernel entry points (``kernels/ops.py``: ``pairwise_sq_l2``,
  ``topk_l2``, ``topk_l2_masked``, ``quant_lb2``, ``lpgf_force``,
  ``flash_attention``), the counter charges that kernel's work by
  ``PERF.md`` section 6's bound law (flash: 4 * hd * B * H * the pairs
  its mask leaves open; bytes: its inputs read and its output written)
  and counts nothing of what runs inside. A fake trace returns an empty
  output of the kernel's shape; a live one launches the kernel. So the
  count describes the card's program, never a plain version's ops.
- Sequential loops by their trip count, as ``hlo.py`` weights while
  bodies: the step of a captured-graph loop (``xlstm._run_steps``: the
  sLSTM's scan, forward and reverse), of a ``graph.scan`` (the mLSTM's
  loops over chunks; its gradient too) and of the train step's
  microbatches runs once under a weight of its trip count, and a graph
  capture (``models/graph.py``) runs its function once and captures
  nothing. xlstm-1.3b's 32,768-step prefill is counted as one step
  times 32,768.

The fake trace runs on CPU tensors. This build of torch (CPU only) makes
fake CUDA tensors, but cannot index or differentiate them: both need a
CUDA device guard. The models' device routes read ``repro_torch.on_card``,
which the counter answers True during a fake trace, so the trace takes
the card's routes: ``attention_stream`` reaches the flash kernel's entry
point, the sLSTM scan and the decode steps their captured graphs.
AdamW's bias corrections and learning rate are host scalars
(``optimizer._scalars``); a fake trace takes them at step 1.

The counter replaces nothing in any module. The kernel entry points and
the loops above are marked ``repro_torch.counted``: a marked function
asks ``repro_torch.op_counter()`` for the counter on its own thread's
dispatch-mode stack (which autograd carries into the threads that run
the backward) and runs the counter's stand-in only if there is one. So
model code on other threads (the checkpointer's hashing, a serving
engine) runs as written while a step is counted.

Memory: every storage an operation allocates is tracked until it is
freed (a weak reference), rounded up to 512 bytes as the card's
allocator rounds it; ``peak_bytes`` is the largest total of such live
storages, the arguments not included.

``collective_bytes`` stays empty: a step on one card runs no
collective, and a per-device SPMD program does not exist here.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# the card's allocator rounds every block up to this many bytes
_ALLOC_ROUND = 512

_DOTS = {aten.mm.default, aten.addmm.default, aten.bmm.default,
         aten.baddbmm.default, aten.convolution.default}
# operations that move no bytes: allocations and metadata (views are
# recognised by their schema)
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.lift_fresh.default,
         aten._local_scalar_dense.default, aten.detach.default,
         aten.alias.default, aten._unsafe_view.default,
         aten.set_.source_Storage_storage_offset,
         aten.record_stream.default}
# gathers: read only what they return (plus their indices)
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
# indexed updates of their first argument: write only the update
_UPDATES = {aten.index_put_.default, aten._index_put_impl_.default,
            aten.index_copy_.default, aten.index_add_.default,
            aten.scatter_.src, aten.scatter_.value, aten.scatter_add_.default,
            aten.index_put.default, aten.index_copy.default,
            aten.index_add.default, aten.scatter.src,
            aten.scatter_add.default}
# operations that overwrite their first argument without reading it
_OVERWRITES = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.zero_.default}


def _nbytes(t: torch.Tensor) -> int:
    """The bytes a read of ``t`` moves: a broadcast (stride-0) dimension
    is read once, not once per index."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return (n if t.numel() else 0) * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts (an operation's
    arguments and results), in order."""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def dot_flops(func, args, out) -> float:
    """2 * prod(result) * prod(contracting dims) of a product."""
    if func is aten.convolution.default:
        w, groups = args[1], args[8]
        contract = (w.shape[1] * math.prod(w.shape[2:]))
        del groups      # w.shape[1] is already C_in / groups
        return 2.0 * out.numel() * contract
    a = args[1] if func in (aten.addmm.default, aten.baddbmm.default) \
        else args[0]
    return 2.0 * out.numel() * a.shape[-1]


@dataclass
class OpStats:
    """What a step did, trip-weighted (``raw_*``: each operation once)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    raw_flops: float = 0.0
    raw_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    n_ops: int = 0                  # operations counted, each once
    n_ops_weighted: float = 0.0     # the same, trip-weighted
    # every trip weight applied: (what, trips)
    trips: List[Tuple[str, int]] = field(default_factory=list)
    # kernel charges by entry point: calls, flops, bytes (trip-weighted)
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    peak_bytes: int = 0             # most live storage beyond the args

    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def charge(self, name: str, flops: float, nbytes: float,
               weight: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += weight
        k["flops"] += weight * flops
        k["bytes"] += weight * nbytes
        self.flops += weight * flops
        self.hbm_bytes += weight * nbytes
        self.raw_flops += flops
        self.raw_bytes += nbytes


def stage_cost_features(stats: OpStats, *, dtype: str = "bf16",
                        n_devices: int = 1) -> Tuple[float, float, float]:
    """``(t_compute, t_memory, t_collective)`` in seconds per device: the
    counts over the H100's peaks (``utils/roofline.py``), divided evenly
    across ``n_devices`` (``hlo.stage_cost_features``'s law)."""
    from repro_torch.utils.roofline import HBM_BW, LINK_BW, peak_flops
    d = max(1, int(n_devices))
    return (stats.flops / d / peak_flops(dtype),
            stats.hbm_bytes / d / HBM_BW,
            stats.total_collective_bytes() / d / LINK_BW)


class Counter(TorchDispatchMode):
    """The dispatch mode that counts; ``count_ops`` yields one.
    ``repro_torch.op_counter`` finds it on the dispatch-mode stack."""

    is_op_counter = True

    def __init__(self, fake: bool = True):
        super().__init__()
        self.fake = fake
        self.stats = OpStats()
        self.weight = 1.0
        self.quiet = 0              # >0 inside a charged kernel
        self.live = 0
        self._known: Dict[int, Any] = {}
        self.stand_ins: Dict[str, Callable] = _stand_ins(self)

    def run(self, fn: Callable, *args):
        """``fn(*args)``, counted; the storages of ``args`` are taken as
        present before it (never counted as its memory)."""
        for t in _tensors(args):
            st = t.untyped_storage()
            self._known.setdefault(id(st), (weakref.ref(st), 0))
        with self:
            return fn(*args)

    def stand_in(self, fn: Callable, args, kwargs):
        """A call of ``fn`` (marked ``repro_torch.counted``) while this
        counter counts: its stand-in, or ``fn`` itself if it has none."""
        sub = self.stand_ins.get(fn.__name__)
        if sub is None:
            return fn(*args, **kwargs)
        return sub(fn, *args, **kwargs)

    @contextlib.contextmanager
    def trip(self, what: str, n: int):
        """What runs inside counts ``n`` times (a loop's one step)."""
        self.stats.trips.append((what, int(n)))
        w = self.weight
        self.weight = w * n
        try:
            yield
        finally:
            self.weight = w

    # ------------------------------------------------------------ memory

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            ent = self._known.get(key)
            if ent is not None and ent[0]() is st:
                continue
            n = -(-st.nbytes() // _ALLOC_ROUND) * _ALLOC_ROUND
            self._known[key] = (weakref.ref(st, self._freer(key, n)), n)
            self.live += n
            if self.live > self.stats.peak_bytes:
                self.stats.peak_bytes = self.live

    def _freer(self, key: int, n: int):
        def free(ref):
            ent = self._known.get(key)
            if ent is not None and ent[0] is ref:
                del self._known[key]
                self.live -= n
        return free

    # --------------------------------------------------------- operations
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "namespace", None) != "aten":
            return out
        self._track(out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.quiet or not outs or func in _FREE or func.is_view:
            return out
        s, w = self.stats, self.weight
        flops = dot_flops(func, args, out) if func in _DOTS else 0.0
        if func in _GATHERS:
            # the rows returned, or the whole source where they repeat it
            src = ins[1] if func is aten.embedding.default else ins[0]
            got = sum(map(_nbytes, outs))
            moved = (sum(map(_nbytes, ins)) - _nbytes(src)
                     + min(_nbytes(src), got) + got)
        elif func in _UPDATES:
            upd = ins[1:]
            moved = sum(map(_nbytes, upd)) + max(
                (_nbytes(t) for t in upd), default=0)
        elif func in _OVERWRITES:
            moved = sum(map(_nbytes, ins[1:])) + _nbytes(ins[0])
        else:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        s.flops += w * flops
        s.hbm_bytes += w * moved
        s.raw_flops += flops
        s.raw_bytes += moved
        s.n_ops += 1
        s.n_ops_weighted += w
        return out


# ---------------------------------------------------------------------------
# Kernel laws (PERF.md section 6): (flops, bytes) of one call
# ---------------------------------------------------------------------------
def attn_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a causal / windowed mask leaves open."""
    i = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def _flash_law(q, k, v, *, causal=True, window=0):
    b, s, h, hd = q.shape
    return (4.0 * hd * b * h * attn_pairs(s, causal, window),
            4.0 * b * s * h * hd * q.element_size())


def _pairwise_law(q, p):
    m, d = q.shape
    n = p.shape[0]
    return 2.0 * m * n * d, 4.0 * (m * d + n * d + m * n)


def _topk_law(q, p, k):
    m, d = q.shape
    n = p.shape[0]
    return 2.0 * m * n * d, 4.0 * (m * d + n * d) + 12.0 * m * k


def _masked_law(q, p, valid, k, lb2=None):
    # every candidate: the counter does not read the mask's data
    g, c, d = p.shape
    return (2.0 * g * c * d,
            4.0 * g * c * d + g * c + 4.0 * g * d + 12.0 * g * k)


def _quant_law(q, codes, cscale, cppq, ceps, valid, *, precision):
    g, c, d = codes.shape
    return (2.0 * g * c * d, codes.element_size() * (g * c * d + g * d)
            + 12.0 * g * c + 5.0 * g * c + 16.0 * g)


def _lpgf_law(points, radius, g_mean):
    n, d = points.shape
    return 3.0 * n * n * d, 4.0 * (2 * n * d + n)


def _fake_out(name: str, args, kwargs):
    """An empty output of the kernel's shape and type."""
    if name == "flash_attention":
        return torch.empty_like(args[0])
    if name == "pairwise_sq_l2":
        q, p = args
        return q.new_empty((q.shape[0], p.shape[0]), dtype=torch.float32)
    if name in ("topk_l2", "topk_l2_masked"):
        q, k = args[0], args[2] if name == "topk_l2" else args[3]
        return (q.new_empty((q.shape[0], k), dtype=torch.float32),
                q.new_empty((q.shape[0], k), dtype=torch.int64))
    if name == "quant_lb2":
        codes = args[1]
        return codes.new_empty(codes.shape[:2], dtype=torch.float32)
    if name == "lpgf_force":
        x = args[0]
        return (torch.empty_like(x, dtype=torch.float32),
                x.new_empty((x.shape[0],), dtype=torch.float32))
    raise KeyError(name)


KERNEL_LAWS: Dict[str, Callable] = {
    "flash_attention": _flash_law, "pairwise_sq_l2": _pairwise_law,
    "topk_l2": _topk_law, "topk_l2_masked": _masked_law,
    "quant_lb2": _quant_law, "lpgf_force": _lpgf_law,
}


# ---------------------------------------------------------------------------
# The counting context
# ---------------------------------------------------------------------------
class _WeightedStep(torch.autograd.Function):
    """One step of a ``graph.scan`` standing for ``n``: the forward counts
    ``n`` times; the backward recomputes the step uncounted, then counts
    its gradient ``n`` times. ``apply(counter, step, n, (n_carry, dim),
    *carry, *xs)`` -> the carry after step 0."""

    @staticmethod
    def forward(ctx, counter, step, n, layout, *inputs):
        ctx.counter, ctx.n, ctx.n_carry = counter, n, layout[0]
        ctx.step = step = _first_step(step, *layout)
        ctx.save_for_backward(*inputs)
        with counter.trip("graph.scan", n):
            return tuple(step(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        counter = ctx.counter
        inputs = [x.detach().requires_grad_(x.requires_grad)
                  for x in ctx.saved_tensors]
        with torch.enable_grad():
            counter.quiet += 1
            try:
                outs = ctx.step(*inputs)
            finally:
                counter.quiet -= 1
        want = [x for x in inputs if x.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        with counter.trip("graph.scan backward", ctx.n):
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], want, [g for _, g in pairs],
                allow_unused=True) if pairs and want else [])
        # autograd sums the n steps' full-size gradients of each scanned
        # tensor: n - 1 additions, two read and one written
        acc = 3.0 * (ctx.n - 1) * sum(_nbytes(x) for x in
                                      inputs[ctx.n_carry:]
                                      if x.requires_grad)
        counter.stats.hbm_bytes += counter.weight * acc
        counter.stats.raw_bytes += acc
        return (None, None, None, None,
                *(next(got, None) if x.requires_grad else None
                  for x in inputs))


def _first_step(step, n_carry: int, dim: int):
    """``step`` of the carry and step 0's slices of the scanned tensors."""
    def first(*inputs):
        return step(*inputs[:n_carry],
                    *(x.select(dim, 0) for x in inputs[n_carry:]))
    return first


class _NoGraph:
    """Stands for a captured graph in a fake trace: nothing to replay."""

    def replay(self):
        raise RuntimeError("a fake trace captures no graph")


def _stand_ins(counter: Counter) -> Dict[str, Callable]:
    """What the counter runs in place of each function marked
    ``repro_torch.counted``, by name: ``stand_in(fn, *args, **kwargs)``,
    ``fn`` the function as written."""
    fake = counter.fake

    @contextlib.contextmanager
    def quiet():
        counter.quiet += 1
        try:
            yield
        finally:
            counter.quiet -= 1

    def kernel(name: str):
        law = KERNEL_LAWS[name]

        def charged(fn, *args, **kwargs):
            flops, nbytes = law(*args, **kwargs)
            counter.stats.charge(name, flops, nbytes, counter.weight)
            with quiet():
                if fake:
                    return _fake_out(name, args, kwargs)
                return fn(*args, **kwargs)
        return charged

    def run_steps(fn, step, n, device, graphed):
        if n <= 0:
            return
        with counter.trip("xlstm._run_steps", n):
            step()
        if not fake:
            with quiet():
                fn(step, n - 1, device, graphed)

    def split(fn, batch, n):
        """The first microbatch, its step weighted by their count (each
        has the same shapes, so the same count); live, the others after
        it, uncounted."""
        mbs = fn(batch, n)
        with counter.trip("microbatches", n):
            yield mbs[0]
        if not fake:
            with quiet():
                yield from mbs[1:]

    def scan(fn, step, carry, xs, dim=1):
        """One step, weighted by the number of steps; each step's
        entering carry is the one step's."""
        n = xs[0].shape[dim]
        if n == 0:
            return carry, []
        out = _WeightedStep.apply(counter, step, n, (len(carry), dim),
                                  *carry, *xs)
        return tuple(out), [tuple(out)] * n

    def capture(fn, step, device):
        first = step()
        return first, _NoGraph(), first

    def capture_live(fn, step, device):
        calls = []

        def once():
            calls.append(1)
            if len(calls) == 1:
                return step()
            with quiet():
                return step()
        return fn(once, device)

    def scalars(fn, tc, count):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            return fn(tc, torch.ones((), dtype=torch.int32))

    out = {name: kernel(name) for name in KERNEL_LAWS}
    out.update(_run_steps=run_steps, split_microbatches=split)
    if fake:
        out.update(scan=scan, capture=capture, _scalars=scalars)
    else:
        out.update(capture=capture_live)
    return out


@contextlib.contextmanager
def count_ops(fake: bool = True, counter_cls=None):
    """A ``Counter`` for one step: make its arguments inside the block
    (fake tensors when ``fake``), then ``counter.run(step, *args)``;
    ``counter.stats`` holds the count. ``counter_cls(fake)`` makes the
    counter (None: ``Counter``); a subclass extends its per-op accounting,
    as ``scripts/flash_projection.py``'s does.
    While ``counter.run`` runs, and on its thread only (and the threads
    autograd runs its backward on), the counter stands in for the kernel
    entry points and the weighted loops (``counter.stand_ins``, each a
    function marked ``repro_torch.counted``); a fake trace also for
    ``graph.scan``, ``graph.capture`` and AdamW's host scalars, and
    ``repro_torch.on_card`` answers True. Nothing of any module is
    replaced, so code on other threads runs as written. A live run
    computes what the step computes: the loops' other steps run,
    uncounted (the mLSTM's ``graph.scan`` is walked and counted step by
    step, the same FLOPs), and a graph capture counts its function's
    first call only."""
    mode = None
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode(allow_non_fake_inputs=True)
    counter = (counter_cls or Counter)(fake)
    with (mode if mode is not None else contextlib.nullcontext()):
        yield counter
