"""Traced GEMM/chain discovery on PyTorch programs (the counterpart of
the reference's ``capture/trace.py``, which walks jaxprs).

``torch.fx.experimental.proxy_tensor.make_fx`` turns a torch callable — a
model's prefill or decode step, a reference program — into an fx graph
of aten operations, traced on fake tensors: nothing is materialized, so
capturing a 32-layer 8B program allocates no device memory.  The trace
is taken at the *pre-dispatch* level, where ``torch.matmul``,
``torch.einsum`` and ``F.linear`` stay single nodes instead of the
``view``/``permute``/``bmm`` sequences the dispatcher lowers them to;
that graph is the counterpart of a jaxpr, whose ``dot_general`` carries
the same batch and contraction structure.  This module walks it to
harvest every contraction the program executes:

  * every contraction node (``matmul``, ``einsum``, ``linear``, ``mm``,
    ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``) becomes a canonical
    :class:`GemmSite` under the paper's GEMM abstraction ``P(x,y) =
    sum_z A(x,z) B(y,z)``: ``m`` is the product of the lhs
    non-contracting non-batch extents, ``n`` the rhs counterpart, ``k``
    the contraction product, and *batch* extents (dims shared by both
    operands: an einsum label in both inputs and the output, a
    ``matmul``'s broadcast batch dims, a ``bmm``'s batch) are flattened
    into the site's repeat weight, as the reference does with
    ``dot_general`` batch dims;
  * Python loops unroll in the trace, so L identical layers give L sites
    that ``program.PlanProgram`` dedupes to weight L — what a ``scan`` of
    length L gives in the reference.  Python branches are resolved at
    trace time (one side is traced).  A ``torch.cond`` or other
    higher-order operator carries its bodies as sub-graphs: each is
    walked once with weight 1, as the reference harvests ``cond``
    branches and ``while`` bodies once.  ``torch.vmap`` has no
    pre-dispatch trace (its batched ops come out as constants): a
    captured program writes its batch as explicit leading dims, which a
    ``matmul`` flattens into ``m`` as the reference's ``vmap`` does;
  * the port's kernel wrappers (``kernels.ops.gemm``, ``fused_mlp`` and
    the scans) are opaque: on fake or meta tensors they return an empty
    tensor of the output's shape (``aten.new_empty``), so a planned
    kernel's interior is not harvested as a workload, as the reference
    treats ``pallas_call``;
  * fusable producer->consumer chains are detected per graph
    (:class:`ChainSite`) as in the reference: a contraction whose A
    operand is produced from one or more same-shape contraction outputs
    through *elementwise-only* ops is the ``core.fusion.GemmChain`` tie,
    and the elementwise path is classified onto the fused kernel's
    combine vocabulary.  Aten op names map onto the reference's
    primitive names (``ATEN_ELEMENTWISE``: ``sigmoid`` is ``logistic``,
    ``to`` is ``convert_element_type``, ``where`` is ``select_n``, ...);
    ``silu``, ``gelu`` and ``relu`` keep their names, which is what the
    reference's classification reads off ``jax.nn``'s calls.  Shape
    ops (``view``/``reshape``/``permute``), reductions and in-place ops
    break the path, which keeps attention's per-head-slice ties out.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import torch
import torch.fx
import torch.utils._pytree as pytree

# Functional aten ops a chain streams through (shape-preserving
# elementwise ops, plus comparisons/select so relu-style gates
# classify), by the name the walk records: the reference's primitive
# name (its ELEMENTWISE_PRIMS), or the activation's name where the
# reference reads it off a ``jax.nn`` call.
ATEN_ELEMENTWISE = {
    **{n: n for n in (
        "add", "sub", "mul", "div", "neg", "abs", "sign", "exp", "exp2",
        "log", "log1p", "expm1", "tanh", "erf", "erfc", "rsqrt", "sqrt",
        "square", "pow", "clamp", "floor", "ceil", "round", "sin", "cos",
        "real", "imag", "gt", "lt", "ge", "le", "eq", "ne")},
    "rsub": "sub", "reciprocal": "div", "maximum": "max",
    "minimum": "min", "clamp_min": "max", "clamp_max": "min",
    "sigmoid": "logistic", "isfinite": "is_finite", "where": "select_n",
    "to": "convert_element_type", "_to_copy": "convert_element_type",
    "type_as": "convert_element_type", "clone": "copy", "alias": "copy",
    "detach": "stop_gradient", "logical_and": "and", "logical_or": "or",
    "logical_not": "not", "logical_xor": "xor", "bitwise_and": "and",
    "bitwise_or": "or", "bitwise_not": "not", "bitwise_xor": "xor",
    "silu": "silu", "gelu": "gelu", "relu": "relu",
}
# broadcasts a path may pass through (the reference's broadcast_in_dim)
_BROADCAST_OPS = frozenset({"expand", "broadcast_to"})

_LINEAR_OPS = frozenset({
    "mul", "add", "sub", "neg", "copy", "convert_element_type",
    "broadcast_in_dim", "stop_gradient", "optimization_barrier"})
# Wrappers a value passes through without changing combine structure.
_CAST_PRIMS = frozenset({"convert_element_type", "copy",
                         "stop_gradient", "optimization_barrier"})

# the contraction nodes, by aten name
CONTRACTIONS = frozenset({"matmul", "einsum", "linear", "mm", "addmm",
                          "bmm", "baddbmm", "mv", "dot"})


@dataclasses.dataclass(frozen=True)
class GemmSite:
    """One harvested contraction site, canonicalized to the paper's GEMM."""

    dims: tuple[int, int, int]     # (m, n, k) with batch dims flattened
    dtype: str                     # output dtype of the site
    weight: int                    # repeat weight incl. batch product
    batch: int                     # flattened batch-dim product
    path: str                      # provenance (graph chain / node index)


@dataclasses.dataclass(frozen=True)
class ChainSite:
    """One detected fusable producer->consumer chain site."""

    producer_dims: tuple[int, int, int]
    consumer_dims: tuple[int, int, int]
    producer_count: int
    elementwise: str               # core.fusion.ELEMENTWISE_OPS member
    weight: int                    # repeat weight incl. batch product
    batch: int
    path: str


@dataclasses.dataclass
class CaptureResult:
    """Raw harvest of one traced program (pre-IR; see capture.program)."""

    name: str
    sites: list[GemmSite] = dataclasses.field(default_factory=list)
    chains: list[ChainSite] = dataclasses.field(default_factory=list)


def _prod(xs) -> int:
    return int(math.prod(xs)) if xs else 1


def _op_name(node: torch.fx.Node) -> str | None:
    """The aten op name of a call_function node (``mm``, ``silu``, ...),
    or None for anything else."""
    if node.op != "call_function":
        return None
    packet = getattr(node.target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(node.target, "__name__", None)


def _shape(arg) -> tuple[int, ...] | None:
    val = arg.meta.get("val") if isinstance(arg, torch.fx.Node) else None
    return tuple(int(s) for s in val.shape) \
        if isinstance(val, torch.Tensor) else None


def _matmul_dims(la, lb):
    """(m, n, k, batch) of ``torch.matmul`` on shapes la, lb, with the
    batch dims split as ``jnp.matmul`` lowers to ``dot_general``: dims
    only in A, or where B's is 1, are A's free dims; dims only in B, or
    where A's is 1, are B's; equal dims are batch."""
    if len(la) == 1 and len(lb) == 1:
        return 1, 1, la[0], 1
    if len(la) == 1:
        return 1, _prod(lb[:-2]) * lb[-1], la[0], 1
    if len(lb) == 1:
        return _prod(la[:-1]), 1, la[-1], 1
    ba, bb = la[:-2], lb[:-2]
    nb = max(len(ba), len(bb))
    ba = (None,) * (nb - len(ba)) + tuple(ba)
    bb = (None,) * (nb - len(bb)) + tuple(bb)
    m, n, batch = la[-2], lb[-1], 1
    for x, y in zip(ba, bb):
        if x is None or (x == 1 and y is not None):
            n *= y
        elif y is None or y == 1:
            m *= x
        else:
            batch *= x
    return m, n, la[-1], batch


def _einsum_dims(equation: str, la, lb):
    """(m, n, k, batch, contracted) of a two-operand einsum, as
    ``jnp.einsum`` lowers it to one ``dot_general``: a label of size 1 on
    one side only is squeezed away, one in a single input and not in the
    output is summed before the product; labels in both inputs and the
    output are batch, in both inputs only contracted, in one input and
    the output free.  jax puts the first operand on the left when
    ``batch + first's free + second's free`` spells the output (no
    transpose needed), else the second — and the left operand's free
    extents are ``m``."""
    eq = equation.replace(" ", "")
    lhs, arrow, out = eq.partition("->")
    ins = lhs.split(",")
    if len(ins) != 2:
        return None
    if not arrow:
        letters = [c for c in lhs if c.isalpha()]
        out = "".join(sorted(c for c in set(letters)
                             if letters.count(c) == 1))
    # an ellipsis stands for the same trailing labels in every operand
    ell = [chr(0x3b1 + i) for i in range(16)]
    specs, width = [], 0
    for spec, shape in zip(ins, (la, lb)):
        if "..." in spec:
            n_ell = len(shape) - (len(spec) - 3)
            width = max(width, n_ell)
            spec = spec.replace("...", "".join(ell[len(ell) - n_ell:]))
        specs.append(dict(zip(spec, (int(s) for s in shape))))
    out = out.replace("...", "".join(ell[len(ell) - width:]))
    x, y = specs
    x = {c: s for c, s in x.items() if not (s == 1 and y.get(c, 1) != 1)}
    y = {c: s for c, s in y.items() if not (s == 1 and x.get(c, 1) != 1)}
    x = {c: s for c, s in x.items() if c in out or c in y}
    y = {c: s for c, s in y.items() if c in out or c in x}
    batch = [c for c in out if c in x and c in y]
    contracted = [c for c in x if c in y and c not in out]
    x_free = [c for c in x if c not in batch and c not in contracted]
    y_free = [c for c in y if c not in batch and c not in contracted]
    left, right = x, y
    if "".join(batch + x_free + y_free) != out:
        left, right, x_free, y_free = y, x, y_free, x_free
    m = _prod([left[c] for c in x_free])
    n = _prod([right[c] for c in y_free])
    k = _prod([x[c] for c in contracted])
    return m, n, k, _prod([x[c] for c in batch]), contracted


def _dot_dims(node: torch.fx.Node) -> tuple[int, int, int, int] | None:
    """(m, n, k, batch) of one contraction node, or None when the site is
    degenerate (zero-extent, or a contraction-free broadcast multiply an
    einsum can express)."""
    nm = _op_name(node)
    args = node.args
    if nm in ("mm", "bmm", "matmul", "mv", "dot"):
        la, lb = _shape(args[0]), _shape(args[1])
    elif nm in ("addmm", "baddbmm"):
        la, lb = _shape(args[1]), _shape(args[2])
    elif nm == "linear":
        la, lw = _shape(args[0]), _shape(args[1])
        lb = None if lw is None else (lw[1], lw[0])
    elif nm == "einsum":
        ops = list(args[1])
        if len(ops) != 2:
            return None
        la, lb = _shape(ops[0]), _shape(ops[1])
        if la is None or lb is None:
            return None
        got = _einsum_dims(args[0], la, lb)
        if got is None:
            return None
        m, n, k, batch, contracted = got
        if 0 in (m, n, k, batch):
            return None
        if k == 1 and min(m, n) == 1 and not contracted:
            return None            # broadcast multiply, not a GEMM
        return m, n, k, batch
    else:
        return None
    if la is None or lb is None:
        return None
    if nm in ("bmm", "baddbmm"):
        m, n, k, batch = la[1], lb[2], la[2], la[0]
    elif nm == "linear":
        m, n, k, batch = _prod(la[:-1]), lb[1], la[-1], 1
    else:
        m, n, k, batch = _matmul_dims(la, lb)
    if 0 in (m, n, k, batch):
        return None
    return m, n, k, batch


def _tensor_args(node: torch.fx.Node) -> list:
    """The node's arguments that are graph values, in order (list and
    tuple arguments flattened), plus Python scalars as None."""
    out = []
    for a in pytree.tree_leaves((node.args, node.kwargs)):
        out.append(a if isinstance(a, torch.fx.Node) else None)
    return out


def _path_name(node: torch.fx.Node) -> str | None:
    """The elementwise name of a node a chain may stream through, or
    None."""
    nm = _op_name(node)
    if nm in _BROADCAST_OPS:
        return "broadcast_in_dim"
    return ATEN_ELEMENTWISE.get(nm)


def _classify_elementwise(ops: set[str]) -> str | None:
    """Map an elementwise-path op set onto the fused kernel's combine
    vocabulary (core.fusion.ELEMENTWISE_OPS); None = not realizable."""
    if "silu" in ops or "logistic" in ops:
        return "silu_mul"
    if "gelu" in ops or "erf" in ops or "tanh" in ops:
        return "gelu_mul"
    if ("relu" in ops or "max" in ops) and \
            ops & {"integer_pow", "square", "pow"}:
        return "sqrelu_mul"
    if ops <= _LINEAR_OPS:
        return "identity"
    return None


def _resolve_casts(v: torch.fx.Node) -> torch.fx.Node:
    """Peel pure-cast wrappers."""
    while _path_name(v) in _CAST_PRIMS:
        v = v.args[0]
    return v


def _combine_is_kernel_shaped(var, producers) -> bool:
    """Multi-producer combines must match the fused kernel's ``act(g) *
    u`` structure: the intermediate's top-level op is a ``mul`` with
    exactly two producers, at least one consumed bare (the un-activated
    u side; both bare = the identity combine ``g * u``), as in the
    reference.  Single-producer chains skip the check."""
    if len(producers) == 1:
        return True
    if len(producers) != 2:
        return False
    top = _resolve_casts(var)
    if _path_name(top) != "mul":
        return False
    bare = sum(_resolve_casts(s) in producers
               for s in _tensor_args(top) if s is not None)
    return bare >= 1


def _trace_intermediate(var, consumer):
    """Walk the consumer's A operand back through elementwise-only ops.

    Returns (producer contraction nodes, op-name set) when (a) every
    tensor leaf of the path is a same-shape contraction output and (b)
    no value computed on the path — producer outputs included — is
    consumed outside the path or returned, so eliding the intermediate's
    round trip through memory is sound; None otherwise (the reference's
    rule, on fx nodes)."""
    target_shape = _shape(var)
    stack, seen = [var], set()
    producers: list = []
    ops: set[str] = set()
    path: list = []
    while stack:
        v = stack.pop()
        if v is None or v in seen:
            continue
        seen.add(v)
        if v.op in ("placeholder", "get_attr"):
            if _shape(v) == ():
                continue            # scalar input (eps, scale, ...)
            return None             # array input feeds the path directly
        nm = _op_name(v)
        if nm in CONTRACTIONS:
            if _shape(v) != target_shape:
                return None
            if v not in producers:
                producers.append(v)
            continue
        name = _path_name(v)
        if name is None:
            return None
        if name != "broadcast_in_dim":
            ops.add(name)
        path.append(v)
        if name == "broadcast_in_dim":
            stack.append(v.args[0])
        else:
            stack.extend(_tensor_args(v))
    if not producers:
        return None
    inside = set(path) | {consumer}
    for node in producers + path:
        for user in node.users:
            if user.op == "output" or user not in inside:
                return None
    return producers, ops


def _detect_chains(graph, weight: int, path: str,
                   out: CaptureResult) -> None:
    for i, node in enumerate(graph.nodes):
        nm = _op_name(node)
        if nm not in CONTRACTIONS:
            continue
        operands = [a for a in _tensor_args(node) if a is not None]
        if nm in ("addmm", "baddbmm"):
            operands = operands[1:]
        if not operands or operands[0].op != "call_function":
            continue
        lhs = operands[0]
        cdims = _dot_dims(node)
        if cdims is None:
            continue
        hit = _trace_intermediate(lhs, node)
        if hit is None:
            continue
        producers, ops = hit
        elem = _classify_elementwise(ops)
        if elem is None:
            continue
        if not _combine_is_kernel_shaped(lhs, producers):
            continue
        pdims = {_dot_dims(p) for p in producers}
        if len(pdims) != 1 or None in pdims:
            continue                # producers must share one shape
        pm, pn, pk, pb = next(iter(pdims))
        cm, cn, ck, cb = cdims
        if pm != cm or pn != ck or pb != cb:
            continue                # the producer-N / consumer-K tie
        out.chains.append(ChainSite(
            producer_dims=(pm, pn, pk), consumer_dims=(cm, cn, ck),
            producer_count=len(producers), elementwise=elem,
            weight=weight * cb, batch=cb, path=f"{path}/chain#{i}"))


def _subgraphs(gm: torch.fx.GraphModule, node: torch.fx.Node):
    """(graph module, tag) of every sub-graph a higher-order operator
    node (``torch.cond``, ``while_loop``, ...) takes as an argument."""
    for a in pytree.tree_leaves((node.args, node.kwargs)):
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            sub = getattr(gm, a.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                yield sub, a.target


def _walk(gm: torch.fx.GraphModule, weight: int, path: str,
          out: CaptureResult) -> None:
    for i, node in enumerate(gm.graph.nodes):
        if _op_name(node) in CONTRACTIONS:
            dims = _dot_dims(node)
            if dims is None:
                continue
            m, n, k, batch = dims
            val = node.meta.get("val")
            dtype = str(val.dtype).removeprefix("torch.") \
                if isinstance(val, torch.Tensor) else "unknown"
            out.sites.append(GemmSite(
                dims=(m, n, k), dtype=dtype, weight=weight * batch,
                batch=batch, path=f"{path}/{_op_name(node)}#{i}"))
            continue
        if node.op == "call_function":
            tag = re.sub(r"\W", "_", str(node.target))
            for sub, attr in _subgraphs(gm, node):
                _walk(sub, weight, f"{path}/{tag}.{attr}", out)
    _detect_chains(gm.graph, weight, path, out)


def harvest_graph(gm: torch.fx.GraphModule, *, name: str = "program",
                  weight: int = 1) -> CaptureResult:
    """Walk a traced fx graph into a raw :class:`CaptureResult` (the
    counterpart of the reference's ``harvest_jaxpr``)."""
    out = CaptureResult(name=name)
    _walk(gm, weight, name, out)
    return out


def _meta_like(x: Any) -> Any:
    """A tensor's stand-in for tracing: the same shape and dtype on the
    meta device (nothing read, nothing allocated); other values as they
    are.  The counterpart of ``jax.ShapeDtypeStruct``."""
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def trace_graph(fn: Callable, *example_args,
                **example_kwargs) -> torch.fx.GraphModule:
    """The pre-dispatch aten graph of ``fn`` on example arguments (any
    pytree; its tensors are traced as fake tensors on the meta device,
    other leaves are constants of the trace).  Tensors ``fn`` closes over
    are constants too: make them on the meta device, as the reference's
    closures are abstract."""
    from torch.fx.experimental.proxy_tensor import make_fx
    leaves, spec = pytree.tree_flatten((example_args, example_kwargs))
    leaves = [_meta_like(x) for x in leaves]
    where = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]

    def flat_fn(*tensors):
        full = list(leaves)
        for i, t in zip(where, tensors):
            full[i] = t
        args, kwargs = pytree.tree_unflatten(full, spec)
        return fn(*args, **kwargs)

    return make_fx(flat_fn, tracing_mode="fake", pre_dispatch=True,
                   _allow_non_fake_inputs=True)(*[leaves[i] for i in where])


def capture(fn: Callable, *example_args, name: str = "program",
            weight: int = 1, **example_kwargs) -> CaptureResult:
    """Trace ``fn`` on example args (tensors on any device, meta tensors
    included — the trace is shape-level, nothing is read or
    materialized) and harvest every contraction site and fusable chain
    it executes."""
    from ..obs.registry import get_registry
    from ..obs.tracing import span as _span
    get_registry().inc("capture.traces")
    with _span("capture.trace", program=name) as sp:
        gm = trace_graph(fn, *example_args, **example_kwargs)
        result = harvest_graph(gm, name=name, weight=weight)
        if sp:
            sp.attrs.update(sites=len(result.sites),
                            chains=len(result.chains))
        return result
