"""Op-trace analysis of one step: FLOPs, bytes and collectives per device.

Port of ``repro.launch.hlo_analysis``. Where the reference parses the
compiled HLO text, the port records the step's aten ops and analyses the
record. Two stages, as in the reference:

``record(fn, *args)``
    runs ``fn`` under a ``TorchDispatchMode`` and returns the op trace (a
    JSON-able dict; the record the dry run saves, as the reference saves
    the HLO text). Each entry holds the aten op, its operands' and
    results' shapes and dtypes, which operands are inputs of the step, a
    fold multiplier, the innermost fold site a forward op runs in
    (``site``), the kind of a collective and the name of one of the
    port's kernels. Over DTensors the mode sees each op at its local
    (per-device) shape: it lets DTensor lower the op and records the local
    ops and the collectives DTensor issues; DTensor's shape propagation,
    which runs each op once more at the global shape under a
    ``FakeTensorMode``, is not recorded.
``analyze(trace, intermediates_only=False)``
    the per-device totals under the reference's keys (``flops``,
    ``bytes``, ``transcendentals``, ``collective_bytes``,
    ``collectives_by_op``, ``collectives_count``, ``bytes_by_kind``,
    ``top_bytes_ops``) and ``flops_by_dtype``, the products' FLOPs by
    operand dtype.

Conventions, the reference's:

  * flops — a product 2·M·N·K (``mm``, ``addmm``, ``bmm``, ``baddbmm``;
    einsum as it decomposes), an elementwise op the result's element
    count, a reduction its operand bytes / 4;
  * bytes — operands plus results of every op; views and metadata ops are
    free; region ops (``index_select``, ``gather``, ``index``,
    ``embedding``) count 2 x result, update ops (``index_put``,
    ``scatter*``, ``index_add``, ``index_copy``) 2 x updates;
  * collectives — ring-weighted per-device bytes (``COLLECTIVE_FACTORS``):
    an all-gather its result, an all-reduce 2 x its operand, a
    reduce-scatter or all-to-all its operand; ``wait_tensor`` is the
    reference's ``*-done`` and counts nothing.

Folds. Torch has no scan: the models' Python loops would be recorded one
iteration at a time. A loop whose iterations have identical shapes is a
fold site (``obs.optrace.trips``): under a folding recorder its first and
last iterations run as they are, and one middle iteration stands for the
other n - 2, its record multiplied by n - 2, as the reference multiplies a
while body by its ``known_trip_count``. The middle iteration's backward is
multiplied too: each autograd node made inside a fold window keeps its
window's multiplier, and a backward op counts at the multiplier of the
node the engine is running (so the engine's add of the middle iteration's
gradient into what every iteration reads counts n - 2 times, as unfolded);
a checkpointed block's recompute counts at the multiplier of its forward
(``optrace.pinned``). The record lists the folds as ``folds`` (site ->
trips).

The port's kernels are opaque: each entry point of ``kernels/ops.py`` is
one entry charged its operands and results once (the reference's
``pallas_call`` is one jaxpr equation), on the card and on the CPU alike,
where the plain version's inner ops are not recorded. So a step's trace is
the same on either device.

Memory. The recorder also follows the step's live storages (each counted
once, across views and in-place updates; freed when the last tensor on
them dies), so a record carries the step's peak. A storage made inside a
fold window that outlives the window counts once per trip (every
iteration's copy would be alive); an activation carried from one folded
iteration to the next is so counted once per trip, an overestimate.

``lowered_hlo_text`` has no counterpart: there is no lowering to text; the
trace is the record.
"""
from __future__ import annotations

import json
import math
import weakref
from collections import defaultdict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.obs import optrace

_DTYPES = {
    torch.float64: ("f64", 8), torch.float32: ("f32", 4),
    torch.float16: ("f16", 2), torch.bfloat16: ("bf16", 2),
    torch.float8_e4m3fn: ("f8e4m3fn", 1), torch.float8_e5m2: ("f8e5m2", 1),
    torch.int64: ("s64", 8), torch.int32: ("s32", 4), torch.int16: ("s16", 2),
    torch.int8: ("s8", 1), torch.uint8: ("u8", 1), torch.bool: ("pred", 1),
    torch.complex64: ("c64", 8), torch.complex128: ("c128", 16),
}
_ITEMSIZE = {name: size for name, size in _DTYPES.values()}

#: the reference's elementwise kinds, as aten names (in-place forms too)
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum", "tanh",
    "exp", "log", "log1p", "rsqrt", "sqrt", "neg", "abs", "sign", "floor",
    "ceil", "cos", "sin", "sigmoid", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "eq", "ne", "lt", "le", "gt", "ge",
    "where", "clamp", "clamp_min", "clamp_max", "_to_copy", "round", "expm1",
    "reciprocal", "silu", "gelu", "softplus", "erf", "exp2", "square",
    "remainder", "fmod", "masked_fill", "lerp", "addcmul", "addcdiv",
    "tanh_backward", "sigmoid_backward", "silu_backward", "gelu_backward",
    "softplus_backward", "threshold_backward", "_softmax",
    "_softmax_backward_data", "_log_softmax", "_log_softmax_backward_data",
    "copy", "isinf", "isnan", "nan_to_num", "trunc", "xlogy",
}
_TRANSCENDENTAL = {
    "tanh", "exp", "log", "log1p", "rsqrt", "sqrt", "sigmoid", "cos", "sin",
    "pow", "expm1", "silu", "gelu", "softplus", "erf", "exp2", "_softmax",
    "_log_softmax", "tanh_backward", "sigmoid_backward", "silu_backward",
    "gelu_backward", "softplus_backward",
}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
           "cumsum", "cumprod", "argmax", "argmin", "logsumexp", "norm",
           "linalg_vector_norm", "var", "std", "topk", "sort"}
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "dot", "convolution"}

#: views and metadata ops: no traffic (the reference's ``_NO_BYTES``);
#: they are not recorded
_NO_BYTES = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "t", "transpose", "permute", "select", "slice",
    "unsqueeze", "squeeze", "as_strided", "detach", "alias", "split",
    "split_with_sizes", "chunk", "unbind", "view_as", "view_as_real",
    "view_as_complex", "lift_fresh", "empty", "empty_strided", "empty_like",
    "new_empty", "new_empty_strided", "unfold", "movedim", "diagonal",
    "narrow", "_conj", "_neg_view", "resolve_conj", "resolve_neg",
    "is_same_size", "_local_scalar_dense", "set", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "_wrap_tensor_autograd",
    "_has_compatible_shallow_copy_type", "unsafe_split", "contiguous",
    "item", "equal", "record_stream",
}
#: ops that touch only a region of their big operand: 2 x result bytes
_REGION_OPS = {"index_select", "gather", "index", "embedding"}
#: ops that write a region: 2 x the update operand's bytes
_REGION_UPDATE_OPS = {"index_put", "_index_put_impl", "scatter",
                      "scatter_add", "scatter_reduce", "index_add",
                      "index_copy"}
#: ops that write their result without reading it
_WRITE_ONLY = {"fill", "zero", "zeros", "ones", "full", "zeros_like",
               "ones_like", "full_like", "arange", "scalar_tensor",
               "new_zeros", "new_ones", "new_full", "normal", "uniform",
               "randn", "rand", "random"}

#: per-device collective traffic: ``(which side, factor)``
COLLECTIVE_FACTORS = {
    "all_gather_into_tensor": ("result", 1.0),
    "all_gather_into_tensor_coalesced": ("result", 1.0),
    "all_reduce": ("operand", 2.0),
    "all_reduce_coalesced": ("operand", 2.0),
    "reduce_scatter_tensor": ("operand", 1.0),
    "reduce_scatter_tensor_coalesced": ("operand", 1.0),
    "all_to_all_single": ("operand", 1.0),
    "broadcast": ("operand", 1.0),
}
_SKIP_DONE = {"wait_tensor"}


def _nbytes(desc) -> int:
    shape, dt = desc[0], desc[1]
    return math.prod(shape) * _ITEMSIZE.get(dt, 0)


def _numel(desc) -> int:
    return math.prod(desc[0])


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _strip(name: str) -> str:
    """An in-place op's name without its trailing ``_`` (``add_`` ->
    ``add``; ``__and__`` stays)."""
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _writes_first(func) -> bool:
    """Whether ``func`` writes its first operand in place."""
    args = func._schema.arguments
    return bool(args) and args[0].alias_info is not None and \
        args[0].alias_info.is_write


def _locals(tree):
    """``tree`` with each DTensor as its local tensor."""
    return pytree.tree_map_only(_dtensor_type(), lambda t: t._local_tensor,
                                tree)


def _replicated_local(t):
    """The whole of DTensor ``t`` on this rank: its local redistributed to
    ``Replicate()`` on every mesh dimension, below autograd."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._redistribute import (
        redistribute_local_tensor)
    spec = t._spec
    target = DTensorSpec(spec.mesh, (Replicate(),) * spec.mesh.ndim,
                         tensor_meta=spec.tensor_meta)
    return redistribute_local_tensor(t._local_tensor, spec, target)


def _replicated_call(func, args, kwargs):
    """``func`` over the whole of every DTensor input; tensor results are
    replicated DTensors on the inputs' mesh, unless the op wrote a plain
    first operand in place."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    mesh = next(t.device_mesh for t in pytree.tree_leaves((args, kwargs))
                if isinstance(t, DTensor))
    rargs, rkwargs = pytree.tree_map_only(DTensor, _replicated_local,
                                          (args, kwargs))
    out = func(*rargs, **rkwargs)
    if _writes_first(func):
        return out

    def wrap(t):
        spec = DTensorSpec(mesh, (Replicate(),) * mesh.ndim,
                           tensor_meta=TensorMeta(t.shape, t.stride(),
                                                  t.dtype))
        return DTensor(t, spec, requires_grad=False)
    return pytree.tree_map_only(torch.Tensor, wrap, out)


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def _local_tensors(tree) -> list:
    """Every tensor leaf of ``tree``, a DTensor as its local tensor."""
    out = []
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            local = getattr(leaf, "_local_tensor", None)
            out.append(local if local is not None else leaf)
    return out


class Recorder(TorchDispatchMode):
    """The dispatch mode ``record`` runs a step under (see the module
    docstring). ``fold`` False records every iteration of a fold site."""

    def __init__(self, inputs=(), fold: bool = True):
        super().__init__()
        self.fold = fold
        self.replicated: list = []
        self.global_flops = 0
        self._in_dtensor = False
        self.ops: list = []
        self.folds: dict = {}
        self.stack = [1]            # trip counts of the open fold windows
        self.sites: list = []       # the fold sites the forward is inside
        self.pins = 0               # > 0 inside a pinned function
        self.windows: list = []     # (lo, hi, mult) of autograd seq numbers
        self._node_mult: dict = {}
        self._quiet = False
        self._dummy = None
        self.input_keys = set()
        self.argument_bytes = 0
        for t in _local_tensors(inputs):
            key = _storage_key(t)
            if key is not None and key not in self.input_keys:
                self.input_keys.add(key)
                self.argument_bytes += t.untyped_storage().nbytes()
        self.live: dict = {}        # storage key -> [bytes, weight]
        self.live_bytes = 0
        self.peak_bytes = 0
        self._allocs: list = []     # storages made in each open window

    # -- multipliers -------------------------------------------------------
    def _mult(self) -> int:
        m = math.prod(self.stack)
        if not self.pins and self.windows:
            node = torch._C._current_autograd_node()
            if node is not None:
                m *= self._mult_of(node._sequence_nr())
        return m

    def _mult_of(self, seq: int) -> int:
        got = self._node_mult.get(seq)
        if got is None:
            got, lo_best = 1, -1
            for lo, hi, mult in self.windows:
                if lo <= seq < hi and lo > lo_best:
                    got, lo_best = mult, lo
            self._node_mult[seq] = got
        return got

    def _seq(self) -> int:
        """The autograd sequence number the next node will take."""
        if self._dummy is None:
            self._dummy = torch.empty((), device="meta", requires_grad=True)
        self._quiet = True
        try:
            with torch.enable_grad():
                return self._dummy.view(()).grad_fn._sequence_nr() + 1
        finally:
            self._quiet = False

    def trips(self, site: str, n: int):
        """Iterations 0 and n - 1 as they are, and between them one
        iteration recorded ``n - 2`` times. The first and the last are
        peeled because their carried state may differ (a zero initial
        state takes no gradient; a final state the step drops gives
        none); the middle one stands for every other. Gradients of what
        every iteration reads meet in the backward as they would
        unfolded: the middle iteration's add into them counts ``n - 2``
        times."""
        self.sites.append(site)
        try:
            if not self.fold or n <= 3:
                yield from range(n)
                return
            self.folds.setdefault(site, set()).add(n)
            yield 0
            yield from self._window(n)
            yield n - 1
        finally:
            self.sites.pop()

    def _window(self, n: int):
        """The folded middle iteration of ``trips``."""
        grad = torch.is_grad_enabled()
        lo = self._seq() if grad else 0
        self.stack.append(n - 2)
        self._allocs.append(set())
        try:
            yield 1
        finally:
            mult = math.prod(self.stack)
            self.stack.pop()
            if grad:
                self.windows.append((lo, self._seq(), mult))
                self._node_mult.clear()
            made = self._allocs.pop()
            for key in made:
                rec = self.live.get(key)
                if rec is None:
                    continue
                self.live_bytes += rec[0] * rec[1] * (n - 3)
                rec[1] *= n - 2
                if self._allocs:
                    self._allocs[-1].add(key)
            self._peak()

    def pinned(self, fn):
        captured = math.prod(self.stack)
        if not self.pins and self.windows:
            node = torch._C._current_autograd_node()
            if node is not None:
                captured *= self._mult_of(node._sequence_nr())

        def run(*args, **kwargs):
            saved, active = self.stack, optrace.ACTIVE.recorder
            self.stack = [captured]
            self.pins += 1
            optrace.ACTIVE.recorder = self   # a recompute's thread
            try:
                return fn(*args, **kwargs)
            finally:
                optrace.ACTIVE.recorder = active
                self.pins -= 1
                self.stack = saved
        return run

    # -- memory --------------------------------------------------------------
    def _peak(self) -> None:
        self.peak_bytes = max(self.peak_bytes,
                              self.argument_bytes + self.live_bytes)

    def _free(self, key) -> None:
        rec = self.live.pop(key, None)
        if rec is not None:
            self.live_bytes -= rec[0] * rec[1]

    def _track(self, tensors) -> None:
        for t in tensors:
            key = _storage_key(t)
            if key is None or key in self.live or key in self.input_keys:
                continue
            st = t.untyped_storage()
            self.live[key] = [st.nbytes(), 1]
            self.live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
            if self._allocs:
                self._allocs[-1].add(key)
        self._peak()

    # -- recording -----------------------------------------------------------
    def _desc(self, t: torch.Tensor, with_input: bool) -> list:
        d = [list(t.shape), _DTYPES.get(t.dtype, (str(t.dtype), 0))[0]]
        if with_input:
            d.append(int(_storage_key(t) in self.input_keys))
        return d

    def _append(self, entry: dict) -> None:
        if self.sites:
            entry["site"] = self.sites[-1]
        self.ops.append(entry)

    def kernel(self, name: str, fn, args: tuple, reads) -> object:
        """``fn(*args)`` (a kernel entry point) as one opaque entry charged
        ``reads`` and its results; nothing inside it is recorded."""
        optrace.ACTIVE.recorder = None
        try:
            with torch.utils._python_dispatch._disable_current_modes():
                out = fn(*args)
        finally:
            optrace.ACTIVE.recorder = self
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        self._append({
            "op": f"kernel.{name}", "m": self._mult(), "kernel": name,
            "in": [self._desc(t, True) for t in reads if t is not None],
            "out": [self._desc(t, False) for t in outs]})
        self._track(outs)
        return out

    def _dtensor_op(self, func, args, kwargs):
        """A DTensor op lowered by DTensor under this mode. When DTensor
        cannot place it (no strategy, or none that keeps an in-place
        operand's placement), the op runs on local tensors instead: an
        in-place write into a DTensor is the owning shard's local update
        (each operand's own local; DTensor would relabel the written
        operand's placement, which is kept), any other op takes every
        DTensor input replicated (the all-gathers counted) and gives
        replicated results. Either way the op is named in
        ``replicated``."""
        DTensor = _dtensor_type()
        self._in_dtensor = True
        inplace = _writes_first(func) and bool(args) and isinstance(
            args[0], DTensor)
        spec = args[0]._spec if inplace else None
        try:
            with self:
                try:
                    out = func(*args, **kwargs)
                except (RuntimeError, NotImplementedError, AssertionError):
                    if inplace:
                        self._note(func, " (local update)")
                        func(*_locals(args), **_locals(kwargs))
                        out = args[0]
                    else:
                        self._note(func)
                        out = _replicated_call(func, args, kwargs)
                    self._count_global(func, args, kwargs, out)
                    return out
        finally:
            self._in_dtensor = False
        self._count_global(func, args, kwargs, out)
        if inplace and args[0]._spec.placements != spec.placements:
            args[0]._spec = spec
            self._note(func, " (local update)")
        return out

    def _count_global(self, func, args, kwargs, out) -> None:
        """``FlopCounterMode``'s count of an op at the shapes its caller
        sees (a DTensor's global shape), each run once: no fold
        multiplier."""
        from torch.utils.flop_counter import flop_registry
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.global_flops += count(*args, **kwargs, out_val=out)

    def _note(self, func, how: str = "") -> None:
        name = str(func) + how
        if name not in self.replicated:
            self.replicated.append(name)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor_type()) for t in types):
            if self._in_dtensor:
                return NotImplemented    # DTensor lowers it: record locals
            return self._dtensor_op(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        flat_in = [a for a in pytree.tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        flat_out = [a for a in pytree.tree_leaves(out)
                    if isinstance(a, torch.Tensor)]
        if any(_is_fake(t) for t in flat_in) or any(
                _is_fake(t) for t in flat_out):
            return out               # DTensor's global shape propagation
        if not self._in_dtensor:
            self._count_global(func, args, kwargs, out)
        ns, _, rest = func._schema.name.partition("::")
        if _strip(rest) in _NO_BYTES:
            self._track(flat_out)
            return out
        entry = {"op": f"{ns}.{rest}.{func._overloadname}",
                 "m": self._mult(),
                 "in": [self._desc(t, True) for t in flat_in],
                 "out": [self._desc(t, False) for t in flat_out]}
        if ns == "_c10d_functional":
            entry["coll"] = rest
        self._append(entry)
        self._track(flat_out)
        return out


def record(fn, *args, fold: bool = True) -> dict:
    """The op trace of ``fn(*args)``: ``{"ops", "folds", "memory",
    "replicated_ops", "flop_counter"}``. ``flop_counter`` is what
    ``torch.utils.flop_counter.FlopCounterMode`` would count over the same
    run (its formulas at the shapes the caller sees, a DTensor's global
    one; a folded loop's body counted as often as it ran).
    ``memory`` holds the step's ``argument_bytes`` (its inputs' storages),
    ``output_bytes`` (its results' storages the step made), ``peak_bytes``
    (inputs plus the live storages at their largest) and ``temp_bytes``
    (the peak less inputs and results). ``fold`` False unrolls every fold
    site. A DTensor op that DTensor cannot place runs on local tensors
    (``Recorder._dtensor_op``) and is named in ``replicated_ops``."""
    rec = Recorder(args, fold=fold)
    prev = optrace.ACTIVE.recorder
    optrace.ACTIVE.recorder = rec
    try:
        with rec:
            out = fn(*args)
    finally:
        optrace.ACTIVE.recorder = prev
    seen, output_bytes = set(), 0
    for t in _local_tensors(out):
        key = _storage_key(t)
        if key in rec.live and key not in seen:
            seen.add(key)
            output_bytes += rec.live[key][0] * rec.live[key][1]
    trace = {
        "ops": rec.ops,
        "folds": {k: (min(v) if len(v) == 1 else sorted(v))
                  for k, v in rec.folds.items()},
        "memory": {
            "argument_bytes": rec.argument_bytes,
            "output_bytes": output_bytes,
            "temp_bytes": max(rec.peak_bytes - rec.argument_bytes
                              - output_bytes, 0),
            "peak_bytes": rec.peak_bytes},
        "replicated_ops": rec.replicated,
        "flop_counter": rec.global_flops}
    del out
    return trace


def _ops(trace) -> list:
    return trace["ops"] if isinstance(trace, dict) else trace


def _op_flops(base: str, entry: dict) -> tuple:
    """``(product flops, product dtype, other flops, transcendentals)``."""
    ins, outs = entry["in"], entry["out"]
    out_elems = _numel(outs[0]) if outs else 0
    if base in _PRODUCTS and len(ins) >= 2:
        if base == "convolution":
            w = ins[1][0]
            return 2.0 * out_elems * math.prod(w[1:]), ins[0][1], 0.0, 0.0
        a, b = (ins[1], ins[2]) if base in ("addmm", "baddbmm") else \
            (ins[0], ins[1])
        k = a[0][-1] if a[0] else 1
        extra = float(out_elems) if base in ("addmm", "baddbmm") else 0.0
        return 2.0 * out_elems * k, a[1], extra, 0.0
    if base in _ELEMENTWISE:
        tr = float(out_elems) if base in _TRANSCENDENTAL else 0.0
        return 0.0, None, float(out_elems), tr
    if base in _REDUCE and ins:
        return 0.0, None, _nbytes(ins[0]) / 4.0, 0.0
    return 0.0, None, 0.0, 0.0


def _op_bytes(base: str, entry: dict, skip_inputs: bool) -> float:
    ins, outs = entry["in"], entry["out"]
    out_b = sum(_nbytes(d) for d in outs)
    if base in _SKIP_DONE:
        return 0.0
    if base in _REGION_OPS:
        return 2.0 * out_b
    if base in _REGION_UPDATE_OPS:
        upd = ins[-1] if len(ins) > 1 else (outs[0] if outs else None)
        return 2.0 * _nbytes(upd) if upd is not None else 0.0
    if base in _WRITE_ONLY:
        return float(out_b)
    if base == "copy" and len(ins) >= 2:      # copy_(self, src)
        src = ins[1]
        return float(out_b) + (0 if skip_inputs and src[2] else _nbytes(src))
    in_b = sum(_nbytes(d) for d in ins if not (skip_inputs and d[2]))
    return float(in_b + out_b)


def _entry_base(entry: dict) -> str:
    op = entry["op"]
    return op if op.startswith("kernel.") else _strip(op.split(".")[1])


def analyze(trace, intermediates_only: bool = False) -> dict:
    """Per-device totals of a ``record`` trace with fold multipliers
    applied (the reference's keys, plus ``flops_by_dtype``: the products'
    FLOPs by operand dtype).

    ``intermediates_only`` switches the byte accounting to the
    materialized-intermediates view: operand reads straight from the
    step's inputs (resident state tables, parameter sets) are excluded, so
    ``bytes`` counts only traffic through buffers the step itself makes.
    Region ops charge the touched slice in both modes."""
    totals = {"flops": 0.0, "bytes": 0.0, "transcendentals": 0.0,
              "collective_bytes": 0.0}
    by_dtype: dict = defaultdict(float)
    by_coll: dict = defaultdict(float)
    n_coll: dict = defaultdict(int)
    bytes_by_kind: dict = defaultdict(float)
    top_ops: list = []
    for e in _ops(trace):
        base = _entry_base(e)
        m = e["m"]
        pf, pdt, of, tr = _op_flops(base, e)
        totals["flops"] += m * (pf + of)
        totals["transcendentals"] += m * tr
        if pf:
            by_dtype[pdt] += m * pf
        b = m * _op_bytes(base, e, intermediates_only)
        totals["bytes"] += b
        bytes_by_kind[base] += b
        if b > 1e9:
            top_ops.append((b, f"{e['op']} x{m:g}"))
        coll = e.get("coll")
        if coll is not None and coll not in _SKIP_DONE:
            side, factor = COLLECTIVE_FACTORS.get(coll, ("operand", 1.0))
            raw = (_nbytes(e["out"][0]) if side == "result"
                   else _nbytes(e["in"][0])) if e["in"] else 0
            totals["collective_bytes"] += m * factor * raw
            by_coll[coll] += m * raw
            n_coll[coll] += int(m)
    totals["flops_by_dtype"] = dict(by_dtype)
    totals["collectives_by_op"] = dict(by_coll)
    totals["collectives_count"] = dict(n_coll)
    totals["bytes_by_kind"] = dict(bytes_by_kind)
    totals["top_bytes_ops"] = [f"{b / 1e9:.1f}GB {s}" for b, s in
                               sorted(top_ops, reverse=True)[:20]]
    return totals


def summarize(trace) -> str:
    return json.dumps(analyze(trace), indent=2)


def trace_traffic(fn, *args, intermediates_only: bool = True) -> dict:
    """The counterpart of the reference's ``jaxpr_traffic``: the bytes of
    one step, every op charged operands plus results, each kernel one
    opaque entry, operands that are the step's inputs skipped with
    ``intermediates_only``. Also ``kernel_launches``, the kernel entries
    of the trace by name (the reference's ``pallas_launches``)."""
    trace = record(fn, *args)
    out = analyze(trace, intermediates_only=intermediates_only)
    launches: dict = defaultdict(int)
    for e in trace["ops"]:
        if "kernel" in e:
            launches[e["kernel"]] += int(e["m"])
    return {"bytes": out["bytes"],
            "bytes_by_primitive": {k: v for k, v in sorted(
                out["bytes_by_kind"].items(), key=lambda kv: -kv[1])},
            "kernel_launches": dict(launches)}


def step_traffic(fn, *args) -> dict:
    """Materialized-intermediate bytes of one step (the reference's
    ``step_traffic``), from the dispatched ops: ``{"bytes", "accounting":
    "dispatch", "bytes_by_kind", "kernel_launches"}``."""
    out = trace_traffic(fn, *args, intermediates_only=True)
    return {"bytes": out["bytes"], "accounting": "dispatch",
            "bytes_by_kind": out["bytes_by_primitive"],
            "kernel_launches": out["kernel_launches"]}
