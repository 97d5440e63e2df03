"""The step cost counter and the hooks that feed it: ``obs.*`` scopes,
collectives and the hand-written kernels' dispatch.

The reference parses the compiled HLO of a step.  The port compiles
nothing: it runs eagerly, one aten op at a time.  So this counter counts
dispatched aten ops, not HLO: ``CostCounter`` is a ``TorchDispatchMode``
that sees every op the step dispatches, on real tensors or on the fake
tensors of the dry run (``torch._subclasses.fake_tensor.FakeTensorMode``)
alike, and the same code counts both.  It counts

  * FLOPs of every product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, which
    ``einsum`` and ``matmul`` reach, the fused attention ops and the
    convolutions), 2 M N K, from ``torch.utils.flop_counter``'s formulas.
    Elementwise work is not counted, as in the reference;
  * bytes: operands + results of every op, less the views and the ops that
    move nothing (``_SKIP_BYTES_OPS``), as the reference skips bitcasts,
    tuples and parameters.  XLA counts at fusion boundaries, this counter at
    each eager op: the two differ by design;
  * collective bytes (each result's bytes) and counts for the reference's
    five kinds, recorded at the one place the port issues them,
    ``repro_torch.dist.collectives`` (``record_collective``);
  * each hand-written kernel at its own cost rule (``run_kernel``, which
    ``repro_torch.kernels.ops`` and ``kernels.wire_hop`` dispatch through):
    its FLOPs and bytes, each input read once and each output written once.
    Whatever implements the kernel (the CUDA launch, the shape rule of a
    fake tensor, the plain version on the CPU) counts as the kernel, and the
    ops it dispatches are not counted again;
  * live bytes: each new storage an op returns counts from its birth until
    it is freed (a ``weakref.finalize`` on the storage).  ``peak_bytes`` is
    the most held at once above what existed when counting began, the
    counterpart of ``torch.cuda.max_memory_allocated()`` less the bytes
    allocated before the step.  A kernel counts its outputs only, as the
    card allocates them; the plain version's scratch is not the kernel's.

Every number is one rank's: under a mesh the step runs on the rank's own
pieces.  Each count lands under the innermost open ``scope`` (the
reference's ``jax.named_scope("obs.*")``), ``UNSCOPED`` outside any.
``repro_torch.launch.hlo_cost.analyze`` reads the reference's keys off a
counter, ``obs.devmem.scope_costs`` its per-scope buckets.

With no counter active a hook costs one global read: ``scope`` returns a
shared no-op context and ``run_kernel`` calls the kernel's implementation;
neither allocates nor records anything.
"""

from __future__ import annotations

import contextlib
import threading
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
UNSCOPED = "(unscoped)"

# The open ``obs.*`` scopes, innermost last, and the innermost active
# counter (None when nothing counts); a counter sets and restores
# ``COUNTER`` as it is entered and left.
SCOPES: list = []
COUNTER = None

_aten = torch.ops.aten
# ``torch.tensor`` and ``torch.from_numpy`` under a fake mode hand their
# data to the dispatcher through a lift: a constant, the reference's
# ``constant``, and no op of the step (a real run makes none).
_LIFTS = frozenset((_aten.lift, _aten.lift_fresh, _aten.lift_fresh_copy))
# Ops that move no bytes of their own: the counterparts of the
# reference's parameter / bitcast / tuple (views are skipped by their
# schema's ``is_view``).
_SKIP_BYTES_OPS = frozenset((
    _aten.detach, _aten.alias, _aten._unsafe_view, _aten.empty,
    _aten.empty_like, _aten.empty_strided,
    _aten.set_, _aten.resize_, _aten._local_scalar_dense,
    _aten.is_same_size, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset,
))


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


# -- tensors -----------------------------------------------------------------

def tensors_in(x):
    """The tensors in ``x``: an op's arguments or result, a step's
    arguments (lists, tuples and dicts of tensors, nested)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from tensors_in(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from tensors_in(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensor_bytes(x) -> int:
    """The bytes of every tensor in ``x`` (a tensor, a list, a tuple or a
    dict of them, nested)."""
    return sum(_nbytes(t) for t in tensors_in(x))


def is_fake(t) -> bool:
    """True for a fake tensor: shapes, types and a device, no data."""
    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """A CUDA tensor, or a fake one: a fake stands for a tensor on the card
    (the dry run's fakes may carry another device; see ``launch.specs``)."""
    return t.is_cuda or isinstance(t, FakeTensor)


def aligned16(t: torch.Tensor) -> bool:
    """16-byte aligned: by its address, or for a fake tensor (which has
    none) by its offset into its storage, which the card's allocator
    aligns."""
    if isinstance(t, FakeTensor):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


# -- hooks -------------------------------------------------------------------

class _Scope:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        SCOPES.append(self.name)
        return self

    def __exit__(self, *exc):
        SCOPES.pop()
        return False


_NO_SCOPE = contextlib.nullcontext()


def scope(name: str):
    """A context that files the costs counted inside under ``name`` (an
    ``obs.*`` name, the reference's ``jax.named_scope``).  With no counter
    active: a shared no-op context."""
    return _NO_SCOPE if COUNTER is None else _Scope(name)


def record_collective(kind: str, x) -> None:
    """Count one collective of ``kind`` whose result is ``x`` (a tensor or
    a tuple of them) on the active counter, if any."""
    c = COUNTER
    if c is not None:
        c.collective(kind, tensor_bytes(x))


def run_kernel(scope_name, cost_rule, shape_rule, plain, cuda, key, *args,
               **kwargs):
    """One call of a hand-written kernel, dispatched on ``key`` (its
    leading tensor): a fake tensor takes ``shape_rule`` (the kernel's
    checks and its outputs, no card query), a CPU tensor ``plain``, any
    other ``cuda`` (which launches or raises).  Under an active
    counter the call counts at ``cost_rule(*args, **kwargs)`` under
    ``scope_name`` (None: the innermost scope already open)."""
    if isinstance(key, FakeTensor):
        impl = shape_rule
    elif key.device.type == "cpu":
        impl = plain
    else:
        impl = cuda
    c = COUNTER
    if c is None:
        return impl(*args, **kwargs)
    return c.kernel(scope_name, cost_rule(*args, **kwargs), impl, *args,
                    **kwargs)


# -- the counter -------------------------------------------------------------

class CostCounter(TorchDispatchMode):
    """Counts what is dispatched while it is entered (``with
    CostCounter() as c:``); see the module docstring.

    ``scopes`` maps each ``obs.*`` scope (the innermost open one,
    ``UNSCOPED`` outside any) to its ``{"flops", "bytes", "ops"}``;
    ``collective_bytes`` and ``collective_counts`` map each of
    ``COLLECTIVES``; ``live_bytes`` and ``peak_bytes`` are the storages
    born inside, now and at most."""

    def __init__(self):
        super().__init__()
        self.scopes = {}
        self.collective_bytes = {k: 0.0 for k in COLLECTIVES}
        self.collective_counts = {k: 0.0 for k in COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._kernel_depth = 0
        self._born = {}                 # id(storage) -> its bytes
        self._lock = threading.Lock()
        self._outer = None
        self._flops = _flop_registry()

    # -- entering and leaving ------------------------------------------------

    def __enter__(self):
        global COUNTER
        self._outer, COUNTER = COUNTER, self
        return super().__enter__()

    def __exit__(self, *exc):
        global COUNTER
        COUNTER, self._outer = self._outer, None
        return super().__exit__(*exc)

    # -- what is counted -----------------------------------------------------

    def _bucket(self) -> dict:
        name = SCOPES[-1] if SCOPES else UNSCOPED
        b = self.scopes.get(name)
        if b is None:
            b = self.scopes[name] = {"flops": 0.0, "bytes": 0.0, "ops": 0.0}
        return b

    def _free(self, key: int, nbytes: int) -> None:
        with self._lock:
            if self._born.pop(key, None) is not None:
                self.live_bytes -= nbytes

    def _track(self, out, args) -> None:
        """Count each storage of ``out`` that is new: not an argument's
        (an in-place op, a view, a detach) and not counted already."""
        inputs = None
        for t in tensors_in(out):
            s = t.untyped_storage()
            key = id(s)
            if key in self._born:
                continue
            if inputs is None:
                inputs = {id(a.untyped_storage()) for a in tensors_in(args)}
            if key in inputs:
                continue
            nb = s.nbytes()
            with self._lock:
                self._born[key] = nb
                self.live_bytes += nb
                if self.live_bytes > self.peak_bytes:
                    self.peak_bytes = self.live_bytes
            weakref.finalize(s, self._free, key, nb)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (self._kernel_depth or func.namespace == "prim"
                or func.overloadpacket in _LIFTS):
            # the kernel's rule counted it; ``prim.device`` and its kin are
            # metadata queries (a fake tensor answers ``.device`` by one)
            return out
        b = self._bucket()
        b["ops"] += 1
        packet = func.overloadpacket
        formula = self._flops.get(packet)
        if formula is not None:
            b["flops"] += formula(*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _SKIP_BYTES_OPS:
            b["bytes"] += tensor_bytes((args, kwargs)) + tensor_bytes(out)
        self._track(out, (args, kwargs))
        return out

    def kernel(self, scope_name, cost, impl, *args, **kwargs):
        """Run ``impl(*args, **kwargs)`` as one hand-written kernel under
        ``scope_name`` (None: the innermost scope already open): ``cost``
        (its ``(flops, bytes)``) is what is counted, the ops ``impl``
        dispatches are not, and of its memory only the outputs that are new
        storages."""
        flops, nbytes = cost
        if scope_name is not None:
            SCOPES.append(scope_name)
        try:
            b = self._bucket()
            b["ops"] += 1
            b["flops"] += flops
            b["bytes"] += nbytes
            self._kernel_depth += 1
            try:
                out = impl(*args, **kwargs)
            finally:
                self._kernel_depth -= 1
            self._track(out, (args, kwargs))
        finally:
            if scope_name is not None:
                SCOPES.pop()
        return out

    def collective(self, kind: str, nbytes: int) -> None:
        self.collective_bytes[kind] += nbytes
        self.collective_counts[kind] += 1

    # -- totals --------------------------------------------------------------

    def totals(self) -> dict:
        return {k: sum(b[k] for b in self.scopes.values())
                for k in ("flops", "bytes", "ops")}
