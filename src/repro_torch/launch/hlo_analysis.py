"""Static flop / byte / memory analysis of one rank's PyTorch program (the
port's counterpart of the reference's ``launch/hlo_analysis.py``, which
reads compiled HLO text).

The port has no compiled program.  Its counterpart is the aten program
that runs when the function runs on tensors of the meta device (its
arguments made meta as ``capture.trace`` makes them): nothing is
allocated, so a full-width step runs on a host without a card.  A
``TorchDispatchMode`` records every aten op below autograd, where each
op is one that eager PyTorch launches as one kernel (``mm`` for a
``matmul``, ``_to_copy`` for a cast), and where a training step's
backward, its remat recompute and its AdamW update appear as the ops
they run.  (``make_fx`` below autograd, the machinery of
``capture.trace``, gives the same ops as an fx graph, but builds it about
eight times slower: 22.5 s against 2.6 s for the 21k ops of llama3-8b's
decode step at a 4096 cache on one rank of the 16 x 16 mesh.)  Python
loops unroll (the layers, the attention's key blocks, the microbatches),
so each iteration is its own ops: no trip multiplier is needed where the
reference multiplies a while body by its ``known_trip_count``.

  * flops: every contraction op (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``mv``, ``dot``: what ``matmul``, ``einsum`` and
    ``linear`` lower to) at 2 x m x n x k x batch, by the product's dtype
    (the roofline charges each dtype at its unit's peak).  The kernel
    wrappers are opaque on meta tensors (an empty output), so each
    reports its own work (``kernels.goma_gemm.note_traced``): B1 and the
    B1 composition 2MNK, B2 its three products, B3 and B4 their products
    at the TF32 rate (their other operations are reported as
    ``other_ops``), ``goma_combine`` none.  As in the reference,
    elementwise flops are not in the term.
  * bytes: operand + result bytes of every op that launches a kernel;
    views, reshapes, allocations and other free ops count zero, as the
    reference's ``_FREE_OPS``.  An operand counts at most its storage
    (a broadcast view is read once), a gather-like op twice its result
    (it reads the addressed rows), an in-place scatter twice its update,
    and a copy into a view its source and destination.  A kernel wrapper
    counts the bytes its function must move.  This is the reference's
    definition at the eager program's granularity: an eager aten op is a
    kernel, as a top-level fused op is in XLA.  The two byte counts
    differ by definition: XLA fuses elementwise chains into one kernel
    whose intermediates stay on chip, and eager PyTorch writes every
    op's result to memory and reads it back.
  * memory: argument and output bytes exactly (each distinct tensor
    once), and the peak of live intermediate bytes over the program,
    each op's result alive from its definition to the last use of its
    storage (its views' uses included): the counterpart of XLA's temp
    size.
"""
from __future__ import annotations

import time

import torch
import torch.utils._pytree as pytree
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from ..capture.trace import _meta_like
from ..kernels.goma_gemm import collect_traced, dtype_key

# ops that launch no kernel: views, allocations without a fill, metadata
FREE_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "t",
    "transpose", "unsqueeze", "squeeze", "slice", "select", "split",
    "split_with_sizes", "unbind", "narrow", "as_strided", "alias",
    "detach", "unflatten", "diagonal", "chunk", "view_as_real",
    "view_as_complex", "empty", "empty_like", "new_empty",
    "new_empty_strided", "empty_strided", "empty_permuted", "lift_fresh",
    "_assert_tensor_metadata", "_assert_async", "sym_size", "sym_numel",
    "sym_stride", "sym_storage_offset", "is_same_size"})
# traffic is twice the result: the addressed rows read, the result written
GATHER_OPS = frozenset({"index", "index_select", "gather", "embedding",
                        "take", "masked_select"})
# in-place updates of a region: its update read and written
SCATTER_OPS = frozenset({"index_put_", "_index_put_impl_", "index_copy_",
                         "scatter_", "scatter_add_", "index_add_",
                         "masked_scatter_", "scatter_reduce_"})
# in-place ops that only write their destination
WRITE_ONLY = frozenset({"copy_", "fill_", "zero_", "normal_", "uniform_"})
CONTRACTIONS = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "addmv",
                          "dot", "vdot"})


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes as a kernel reads them: its elements, at most its
    storage (a broadcast view is read once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _storage(t: torch.Tensor) -> StorageWeakRef:
    return StorageWeakRef(t.untyped_storage())


def contraction_flops(name: str, ins: list) -> float:
    """2 x m x n x k x batch of one contraction op, from its operands
    (``addmm``'s and ``baddbmm``'s bias first)."""
    if name in ("addmm", "baddbmm", "addmv"):
        ins = ins[1:]
    a, b = ins[0].shape, ins[1].shape
    if name in ("mm", "addmm"):
        return 2.0 * a[0] * b[1] * a[1]
    if name in ("bmm", "baddbmm"):
        return 2.0 * a[0] * a[1] * b[2] * a[2]
    if name in ("mv", "addmv"):
        return 2.0 * a[0] * a[1]
    return 2.0 * a[0]                           # dot, vdot


class _Recorder(TorchDispatchMode):
    """Records every aten op the program runs: (name, input tensors,
    output tensors)."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, list, list]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch.is_inference_mode_enabled():
            # the autograd keys are off, so composite ops (matmul, einsum,
            # to) reach the mode whole: run their decomposition, as the
            # backend would, its ops recorded here
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.ops.append((func.overloadpacket.__name__,
                         _tensors((args, kwargs)), _tensors(out)))
        return out


def op_bytes(name: str, ins: list, outs: list) -> int:
    """The bytes the kernel one op launches reads and writes."""
    out = sum(_nbytes(t) for t in outs)
    if name in GATHER_OPS:
        return 2 * out
    if name in SCATTER_OPS:
        # self, indices..., the update: the update read and written
        return 2 * (_nbytes(ins[-1]) if ins else 0)
    if name in WRITE_ONLY:
        return out + sum(_nbytes(t) for t in ins[1:])
    return out + sum(_nbytes(t) for t in ins)


def _live_peak(ops: list, args: list, outputs: list) -> int:
    """The peak of live intermediate bytes: every storage an op creates
    is held from that op to the last op that reads or writes it (through
    any view); arguments' and outputs' storages are not intermediates."""
    fixed = {_storage(t) for t in args + outputs}
    born: dict = {}
    last: dict = {}
    size: dict = {}
    for i, (_, ins, outs) in enumerate(ops):
        for t in ins + outs:
            s = _storage(t)
            if s in fixed:
                continue
            if s not in born:
                born[s] = i
                size[s] = t.untyped_storage().nbytes()
            last[s] = i
    delta = [0] * (len(ops) + 1)
    for s, i in born.items():
        delta[i] += size[s]
        delta[last[s] + 1] -= size[s]
    live = peak = 0
    for d in delta:
        live += d
        peak = max(peak, live)
    return peak


def analyze_ops(ops: list, kernel_calls: list, args: list,
                outputs: list) -> dict:
    """The totals of a recorded program (``analyze_program``) and of the
    kernel calls it passed."""
    flops: dict[str, float] = {}
    nbytes = 0
    n_ops = 0
    for name, ins, outs in ops:
        if name in FREE_OPS:
            continue
        n_ops += 1
        if name in CONTRACTIONS:
            key = dtype_key(outs[0].dtype)
            flops[key] = flops.get(key, 0.0) + contraction_flops(name, ins)
        nbytes += op_bytes(name, ins, outs)
    kernels: dict[str, dict] = {}
    other = 0
    for call in kernel_calls:
        for key, f in call["flops"].items():
            flops[key] = flops.get(key, 0.0) + float(f)
        nbytes += call["bytes"]
        other += call["other_ops"]
        row = kernels.setdefault(call["name"], {"calls": 0, "shapes": {}})
        row["calls"] += 1
        shape = "x".join(map(str, call["shape"]))
        row["shapes"][shape] = row["shapes"].get(shape, 0) + 1

    def distinct_bytes(ts):
        seen = {id(t): t for t in ts}
        return sum(t.numel() * t.element_size() for t in seen.values())
    return {"flops": float(sum(flops.values())), "flops_by_dtype": flops,
            "bytes": float(nbytes), "other_ops": other,
            "kernels": kernels, "ops": n_ops,
            "memory": {"argument_size_in_bytes": distinct_bytes(args),
                       "output_size_in_bytes": distinct_bytes(outputs),
                       "temp_size_in_bytes": _live_peak(ops, args,
                                                        outputs)}}


def analyze_program(fn, *example_args, **example_kwargs) -> dict:
    """Run ``fn`` on example arguments as meta tensors (tensors of any
    device stand in as meta tensors of their shape and dtype; tensors
    ``fn`` closes over must be meta) and return one rank's totals:
    ``flops`` and ``flops_by_dtype``, ``bytes``, ``other_ops`` (the scans'
    operations besides their products), ``kernels`` (the port's kernel
    calls by name, with their shapes), ``ops`` (kernel-launching aten
    ops), ``memory`` (argument, output and peak temp bytes) and
    ``trace_s`` (the host seconds of the run and the walk).  Collectives
    are counted by the callers' ``comm`` records, which meta tensors fill
    without running them (``launch.roofline``)."""
    t0 = time.perf_counter()
    args, kwargs = pytree.tree_map(_meta_like,
                                   (example_args, example_kwargs))
    with collect_traced() as calls, _Recorder() as rec:
        out = fn(*args, **kwargs)
    result = analyze_ops(rec.ops, calls, _tensors((args, kwargs)),
                         _tensors(out))
    result["trace_s"] = time.perf_counter() - t0
    return result


__all__ = ["analyze_ops", "analyze_program"]
