"""Graph invariant passes: certify what the paper *claims* about the graph.

The headline claim is structural: DA replaces every weight multiply with
shift-and-add over stored weight-sums.  These passes prove the traced
serving steps honor that contract instead of trusting the numerics tests.
They are the reference's four passes (``repro.analysis.passes``) over FX
graphs of ``aten`` ops, with the reference's lattice and op classes:

* ``multiplier-free`` (taint): no float ``mm`` / ``bmm`` / ``addmm`` /
  ``matmul`` / ``einsum`` / convolution consumes a value on the weight
  datapath.  Weight leaves are taint sources; integer codes/LUTs taint
  ``INT_EXACT``, raw float weights taint ``FLOAT``.  A float dot over a
  ``FLOAT``-tainted operand is the multiplier the paper eliminated.  An
  ``INT_EXACT`` operand may reach a float dot only when the *other* operand
  is a 0/1 selector (a one-hot address row or an extracted bit-plane).  An
  integer dot (``_int_mm``, an int32 ``mm``) is shift-add by construction.
  A kernel's custom-op node is opened as the reference opens a
  ``pallas_call``: the op's plain version, traced over the node's fake
  inputs, stands for the kernel body.
* ``no-big-gather``: no ``index`` / ``gather`` / ``index_select`` node of a
  fused-attention step produces the ``[B, W·ps, kv, hd]`` page-table view's
  bytes or more (the reference reads this from HLO; there is no HLO here).
* ``no-host-sync``: no ``.item()`` / ``_local_scalar_dense`` / ``nonzero``,
  no copy to the CPU, no Python callback and no float64 conversion in the
  step; a custom op outside the port's own namespace is a warning.
* ``dtype-discipline``: no sub-f32 ``exp``; no 64-bit dot; no other 64-bit
  value.  Torch indexes in int64 where JAX indexes in int32, so an int64
  index value (``arange``, ``argmax``, a table cast for indexing) is not a
  64-bit value here; an int64 *sum* of narrower integers is (the
  accumulator widened).

Each finding's ``where`` comes from the node's recorded stack: the
innermost frame of the port (``src/repro_torch/...:line``) followed by the
chain of the port's functions that led there, innermost first, so the
allowlist matches a file, a line or a function by substring.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import operator
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.findings import Finding

#: The reference's default allowlist: the bit-slicing *baseline*
#: (``core/bitslice.py``) is the paper's comparison datapath and keeps
#: conventional partial-product multiplies by design.
REFERENCE_ALLOWLIST: Tuple[str, ...] = ("bitslice_vmm", "core/bitslice.py")

#: The port's float64 sites, each on purpose, and each by name:
#: * ``paged_gather_read`` (``models/attention.py``: the ``gather`` backend
#:   and the attention kernel's plain version) sums q·k, the softmax row sum
#:   and p·v in float64: it is the kernel's bitwise oracle, whose rounding
#:   must not depend on the summation order.  Only the ``gather`` steps hold
#:   it; in the ``fused`` steps the kernel is one opaque op.
#: * ``_mean_square`` and ``_row_mean`` (``models/layers.py``: every norm's
#:   sum of squares, and the LayerNorm mean) sum in float64 so that a row
#:   rounds alike at any batch on CUDA (spec and prefix tokens equal the
#:   plain serve's only because of it).  Every step holds them, the
#:   ``fused`` ones too.
#: The reference's steps hold no float64 (JAX runs with x64 off), so these
#: sites would be no-host-sync and dtype-discipline findings without them.
PORT_FLOAT64_SITES: Tuple[str, ...] = ("paged_gather_read", "_mean_square",
                                       "_row_mean")

#: The passes that flag a float64 value.
FLOAT64_PASSES: Tuple[str, ...] = ("graph/no-host-sync", "graph/dtype-discipline")

#: The port's default allowlist: the reference's, plus its float64 sites,
#: each scoped to the two passes that flag float64 (``PASS@SUBSTR``), so a
#: page-view gather of ``paged_gather_read`` in a fused step still fails.
DEFAULT_ALLOWLIST: Tuple[str, ...] = REFERENCE_ALLOWLIST + tuple(
    f"{p}@{site}" for site in PORT_FLOAT64_SITES for p in FLOAT64_PASSES)


# ---------------------------------------------------------------------------
# Taint lattice (the reference's)
# ---------------------------------------------------------------------------


class Flavor(enum.IntEnum):
    """Weight-datapath taint flavor, ordered for lattice joins."""

    NONE = 0        # not weight-derived (activations, indices, constants)
    INT_EXACT = 1   # integer weight codes / LUT sums, exact so far
    FLOAT = 2       # float weight values (raw or dequantized pre-reduce)


@dataclasses.dataclass(frozen=True)
class Taint:
    """Per-value state: weight flavor + is the value a 0/1 selector."""

    flavor: Flavor = Flavor.NONE
    selector: bool = False

    def join(self, other: "Taint") -> "Taint":
        return Taint(
            flavor=Flavor(max(self.flavor, other.flavor)),
            selector=self.selector and other.selector,
        )


UNTAINTED = Taint()
SELECTOR = Taint(flavor=Flavor.NONE, selector=True)

# The reference's op classes (``repro.analysis.passes``), as aten op names.
# Ops through which taint and selector-ness pass unchanged from the first
# (data) operand; trailing operands are indices/sizes.
_SHAPE_ONLY = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "expand", "expand_as", "slice", "select",
    "narrow", "flip", "clone", "contiguous", "alias", "detach", "_to_copy",
    "to", "type_as", "as_strided", "unfold", "flatten", "movedim",
    "split", "split_with_sizes", "unbind", "chunk", "diagonal", "view_as",
    "index", "gather", "index_select", "repeat", "repeat_interleave",
    "lift_fresh_copy", "_reshape_alias", "unflatten", "squeeze_copy",
    "view_copy", "permute_copy", "expand_copy", "slice_copy", "select_copy",
    "roll",
}
# Ops joining several data operands; selector survives iff all are selectors.
_JOIN_DATA = {"cat", "stack", "constant_pad_nd", "pad", "where", "clamp",
              "clamp_min", "clamp_max", "index_put", "index_put_", "scatter",
              "scatter_", "scatter_add", "scatter_add_", "sort", "masked_fill",
              "masked_fill_", "copy", "copy_", "slice_scatter",
              "select_scatter", "fill", "fill_"}
# Bitwise / integer-exact arithmetic: flavor passes through.
_INT_EXACT_OK = {
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "neg", "abs",
    "maximum", "minimum", "remainder", "fmod", "sign", "bitwise_left_shift",
    "bitwise_right_shift", "__lshift__", "__rshift__", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "floor_divide",
}
# Comparisons: output is a fresh 0/1 selector, flavor drops.
_COMPARE = {"eq", "ne", "lt", "gt", "le", "ge", "logical_and", "logical_or",
            "logical_not", "logical_xor"}
# Reductions that end a shift-add accumulation chain.
_REDUCE = {"sum", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
           "any", "all", "mean", "cumsum", "cumprod", "logsumexp"}
# Value-killing ops: outputs carry no weight information.
_FRESH = {"arange", "empty", "empty_like", "empty_strided", "zeros",
          "zeros_like", "ones", "ones_like", "full", "full_like",
          "scalar_tensor", "new_empty", "new_empty_strided", "new_zeros",
          "new_ones", "new_full", "rand", "randn", "randint", "rand_like",
          "randn_like", "bernoulli", "one_hot"}
# Dots: (kind, positions of the two operands).
_DOTS = {"mm": (0, 1), "bmm": (0, 1), "matmul": (0, 1), "dot": (0, 1),
         "mv": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2), "addbmm": (1, 2),
         "linear": (0, 1), "_int_mm": (0, 1), "convolution": (0, 1),
         "conv1d": (0, 1), "conv2d": (0, 1), "einsum": None}
# Exponentials (dtype-discipline's softmax rule).
_EXP = {"exp", "exp2", "expm1", "_softmax", "softmax", "_log_softmax",
        "log_softmax", "_safe_softmax"}
# Ops that hand a device value to the host, or depend on one.
_HOST_SYNC = {"_local_scalar_dense", "item", "nonzero", "nonzero_static",
              "masked_select", "_assert_async", "unique", "_unique2",
              "tolist"}
# Index-producing gathers (no-big-gather).
_GATHERS = {"index", "gather", "index_select", "take", "take_along_dim"}
# Sums whose int64 result from narrower integers is a widened accumulator.
_ACCUMULATE = {"sum", "prod", "cumsum", "cumprod", "mean"}

_MF_PASS = "graph/multiplier-free"

#: namespaces whose ops stay on the device
_DEVICE_NAMESPACES = ("aten", "prims", "repro_torch")
#: the port's kernels' namespace
PORT_NAMESPACE = "repro_torch"


# ---------------------------------------------------------------------------
# Node helpers
# ---------------------------------------------------------------------------


def _op_name(node: Any) -> Optional[str]:
    """The aten-level name of a call_function node (``mm`` for
    ``aten.mm.default``), or None for a non-op target."""
    target = node.target
    return target._opname if isinstance(target, torch._ops.OpOverload) else None


def _namespace(node: Any) -> Optional[str]:
    target = node.target
    return target.namespace if isinstance(target, torch._ops.OpOverload) else None


def port_op_name(node: Any) -> Optional[str]:
    """``bitplane_vmm`` ... for a node of one of the port's kernel ops."""
    if node.op == "call_function" and _namespace(node) == PORT_NAMESPACE:
        return _op_name(node)
    return None


def _val(node: Any) -> Any:
    return node.meta.get("val") if hasattr(node, "meta") else None


def _vals(node: Any) -> List[torch.Tensor]:
    """The tensors a node produces (one, or each of a tuple's)."""
    v = _val(node)
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [x for x in v if isinstance(x, torch.Tensor)]
    return []


def _dtype(x: Any) -> Optional[torch.dtype]:
    v = _val(x) if isinstance(x, torch.fx.Node) else x
    return v.dtype if isinstance(v, torch.Tensor) else None


def _is_float(x: Any) -> bool:
    dt = _dtype(x)
    return dt is not None and dt.is_floating_point


def _nbytes(node: Any) -> int:
    return sum(v.numel() * v.element_size() for v in _vals(node))


def _type_str(node: Any) -> str:
    vals = _vals(node)
    if not vals:
        return ""
    v = vals[0]
    return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"


_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')
_PORT = os.sep + "repro_torch" + os.sep
_SKIP = os.sep + os.path.join("repro_torch", "analysis") + os.sep


def _where(node: Any) -> str:
    """``src/repro_torch/<file>:<line> in <fn> < <caller> < ...``: the
    innermost frame of the port in the node's recorded stack, then the
    chain of port functions around it, innermost first ("" when the trace
    kept no stack)."""
    stack = node.meta.get("stack_trace") if hasattr(node, "meta") else None
    if not stack:
        return ""
    frames = [(f, int(line), fn) for f, line, fn in _FRAME.findall(stack)
              if _PORT in f and _SKIP not in f]
    if not frames:
        return ""
    path, line, fn = frames[-1]
    cut = path.rfind(os.sep + "src" + _PORT)
    rel = (path[cut + 1:] if cut >= 0 else path).replace(os.sep, "/")
    chain = " < ".join(f for _, _, f in reversed(frames[:-1]))
    return f"{rel}:{line} in {fn}" + (f" < {chain}" if chain else "")


def _literal_is_one(arg: Any) -> bool:
    return isinstance(arg, int) and not isinstance(arg, bool) and arg == 1


def _node_args(node: Any) -> List[Any]:
    """Positional args, lists flattened (``cat``/``stack`` take a list)."""
    out: List[Any] = []
    for a in node.args:
        if isinstance(a, (list, tuple)):
            out.extend(a)
        else:
            out.append(a)
    return out


# ---------------------------------------------------------------------------
# multiplier-free: the taint interpreter
# ---------------------------------------------------------------------------


#: the plain version of each kernel op, traced once per argument signature
_PLAIN_GRAPHS: Dict[Tuple, Any] = {}


def _plain_subgraph(node: Any) -> Any:
    """The op's plain version traced in fake mode over inputs of the node's
    shapes, strides and dtypes (empty CPU tensors: their pages are never
    touched), memoized per signature."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels.ops import PLAIN

    name = _op_name(node)
    sig = [name]
    for a in node.args:
        v = _val(a) if isinstance(a, torch.fx.Node) else a
        sig.append((tuple(v.shape), tuple(v.stride()), v.dtype)
                   if isinstance(v, torch.Tensor) else v)
    key = tuple(sig)
    if key not in _PLAIN_GRAPHS:
        tensors = [(i, v) for i, v in enumerate(
            _val(a) if isinstance(a, torch.fx.Node) else a for a in node.args)
            if isinstance(v, torch.Tensor)]
        args = [(_val(a) if isinstance(a, torch.fx.Node) else a) for a in node.args]

        def plain(*ts):
            full = list(args)
            for (i, _), t in zip(tensors, ts):
                full[i] = t
            return PLAIN[name](*full)

        inputs = [torch.empty_strided(v.shape, v.stride(), dtype=v.dtype)
                  for _, v in tensors]
        _PLAIN_GRAPHS[key] = (make_fx(plain, tracing_mode="fake")(*inputs),
                              [i for i, _ in tensors])
    return _PLAIN_GRAPHS[key]


class _TaintInterpreter:
    """Abstract interpreter propagating weight taint through an FX graph."""

    def __init__(self, findings: List[Finding], step_name: str) -> None:
        self.findings = findings
        self.step_name = step_name

    def _taint(self, env: Dict[Any, Taint], arg: Any) -> Taint:
        if isinstance(arg, torch.fx.Node):
            return env.get(arg, UNTAINTED)
        return UNTAINTED

    def run(self, gm: Any, args: Sequence[Taint], where: str = "") -> List[Taint]:
        """Propagate through one graph; returns the output taints."""
        env: Dict[Any, Taint] = {}
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        for node, t in zip(placeholders, args):
            env[node] = t
        outs: List[Taint] = []
        for node in gm.graph.nodes:
            if node.op == "call_function":
                env[node] = self._node(env, node, where)
            elif node.op == "get_attr":
                env[node] = UNTAINTED
            elif node.op == "output":
                flat = node.args[0]
                flat = flat if isinstance(flat, (list, tuple)) else [flat]
                outs = [self._taint(env, a) for a in torch.utils._pytree.tree_leaves(
                    flat)]
        return outs

    def _node(self, env: Dict[Any, Taint], node: Any, where: str) -> Taint:
        if node.target is operator.getitem:
            return self._taint(env, node.args[0])
        if port_op_name(node) is not None:
            return self._kernel(env, node)
        name = _op_name(node)
        args = _node_args(node)
        taints = [self._taint(env, a) for a in args]
        if name in _DOTS:
            self._check_dot(env, node, name, where)
            return UNTAINTED
        return self._default(name, node, args, taints)

    def _default(self, name: Optional[str], node: Any, args: List[Any],
                 taints: List[Taint]) -> Taint:
        joined = UNTAINTED
        for t in taints:
            joined = Taint(Flavor(max(joined.flavor, t.flavor)), False)
        if name in _FRESH:
            return UNTAINTED
        if name in _COMPARE:
            return SELECTOR
        if name in _SHAPE_ONLY:
            return taints[0] if taints else UNTAINTED
        data = [t for a, t in zip(args, taints) if isinstance(a, torch.fx.Node)]
        if name in _JOIN_DATA:
            sel = bool(data) and all(
                t.selector or not t.flavor for t in data
            ) and any(t.selector for t in data)
            return Taint(joined.flavor, sel)
        if name == "bitwise_and" and any(_literal_is_one(a) for a in args):
            # bit extraction: and(x >> b, 1) yields a 0/1 plane
            return Taint(joined.flavor, True)
        if name in _REDUCE:
            # accumulation endpoint: the shift-add chain terminates here;
            # what leaves is an inner-product value, not a weight
            return UNTAINTED
        if name in _INT_EXACT_OK and not _is_float(node):
            sel = bool(data) and all(
                t.selector or not t.flavor for t in data
            ) and any(t.selector for t in data)
            return Taint(joined.flavor, sel)
        if _is_float(node) and joined.flavor == Flavor.INT_EXACT:
            # float arithmetic on exact codes before any reduction: the
            # value is now a float weight surrogate (the dequantize-then-
            # matmul cheat) — escalate so a downstream dot flags it
            return Taint(Flavor.FLOAT, False)
        return joined

    def _operands(self, node: Any, kind: str) -> List[Any]:
        if kind == "einsum":  # einsum(equation, [operands])
            ops = node.args[1] if len(node.args) > 1 else []
            return list(ops)[:2]
        i, j = _DOTS[kind]
        return [node.args[i], node.args[j]]

    def _check_dot(self, env: Dict[Any, Taint], node: Any, kind: str,
                   where: str) -> None:
        operands = self._operands(node, kind)
        taints = [self._taint(env, a) for a in operands]
        if not _is_float(node) and not any(_is_float(a) for a in operands):
            return  # integer dot: shift-add by construction
        at = where or _where(node)
        pair = list(zip(taints, reversed(taints)))
        for i, (mine, other) in enumerate(pair):
            side = "lhs" if i == 0 else "rhs"
            if mine.flavor == Flavor.FLOAT:
                self.findings.append(Finding(
                    pass_name=_MF_PASS, severity="error",
                    op=f"{kind}({side} float weight operand)",
                    hint="a float matmul consumes weight values — the "
                         "multiplier the paper eliminated; freeze the "
                         "layer (PackedWeights) or allowlist a baseline",
                    where=at, step=self.step_name,
                ))
            elif mine.flavor == Flavor.INT_EXACT and not other.selector:
                self.findings.append(Finding(
                    pass_name=_MF_PASS, severity="error",
                    op=f"{kind}({side} integer weight codes x non-selector)",
                    hint="integer weight codes may meet a float dot only "
                         "against a 0/1 selector (one-hot LUT address or "
                         "extracted bit-plane); this operand is a general "
                         "float value — a real multiply over weights",
                    where=at, step=self.step_name,
                ))

    def _kernel(self, env: Dict[Any, Taint], node: Any) -> Taint:
        """A kernel op, opened as the reference opens a ``pallas_call``:
        the op's plain version stands for the kernel body.  A finding
        inside it is placed at the op's call site."""
        sub, tensor_pos = _plain_subgraph(node)
        seeds = [self._taint(env, node.args[i]) for i in tensor_pos]
        outs = self.run(sub, seeds, where=_where(node))
        return functools.reduce(Taint.join, outs) if outs else UNTAINTED


# ---------------------------------------------------------------------------
# Pass entry points
# ---------------------------------------------------------------------------


def multiplier_free(gm: Any, arg_taints: Sequence[Taint],
                    step_name: str = "") -> List[Finding]:
    """Taint-check one traced step's graph (allowlist applied by
    :func:`run_passes`)."""
    findings: List[Finding] = []
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(arg_taints) != len(placeholders):
        raise ValueError(
            f"{step_name}: {len(arg_taints)} arg taints for "
            f"{len(placeholders)} graph inputs — seed taints with "
            "graph.arg_taints over the same flattened arguments"
        )
    _TaintInterpreter(findings, step_name).run(gm, list(arg_taints))
    return findings


def _source(node: Any) -> Any:
    """The node a value was read from, through shape-only ops and in-place
    writes (a layer's pool is a ``select`` of the stacked pool placeholder,
    and the step's K/V rows are ``index_put_`` into it before the read)."""
    while node.op == "call_function" and node.args \
            and isinstance(node.args[0], torch.fx.Node) \
            and ((_op_name(node) or "") in _SHAPE_ONLY
                 or (_op_name(node) or "").endswith("_")):
        node = node.args[0]
    return node


def no_big_gather(gm: Any, view_bytes: int, step_name: str = "",
                  pools: Optional[Sequence[int]] = None) -> List[Finding]:
    """No gather at (or above) the re-materialized page-table KV view size
    — the op the fused page walk exists to remove.  With ``pools`` (the
    placeholder positions of the KV pools) only a gather that reads a pool
    counts: the CPU's plain LUT readout gathers weight tables by PMA
    address, which XLA fuses out of the reference's HLO."""
    findings: List[Finding] = []
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    pool_nodes = None if pools is None else {placeholders[i] for i in pools}
    for node in gm.graph.nodes:
        if node.op != "call_function" or _namespace(node) != "aten" \
                or _op_name(node) not in _GATHERS:
            continue
        if pool_nodes is not None and _source(node.args[0]) not in pool_nodes:
            continue
        nbytes = _nbytes(node)
        if nbytes >= view_bytes:
            findings.append(Finding(
                pass_name="graph/no-big-gather", severity="error",
                op=f"{_op_name(node)} {node.name}", bytes=nbytes,
                hint=f"materializes >= the [B, W*ps, kv, hd] page-table "
                     f"view ({view_bytes} B) inside a fused-attention "
                     "step; the page walk must stay in-kernel",
                where=_where(node), step=step_name,
            ))
    return findings


def no_host_sync(gm: Any, step_name: str = "") -> List[Finding]:
    """The step must never synchronize with the host mid-step."""
    findings: List[Finding] = []
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = _op_name(node)
        where = _where(node)
        if name is None and node.target is not operator.getitem:
            findings.append(Finding(
                pass_name="graph/no-host-sync", severity="error",
                op=f"callback {node.name} target="
                   f"{getattr(node.target, '__name__', node.target)!r}",
                bytes=_nbytes(node),
                hint="a Python callback in the hot path serializes every "
                     "step on the Python thread",
                where=where, step=step_name,
            ))
            continue
        if name is None:
            continue
        ns = _namespace(node)
        src = node.args[0] if node.args else None
        src_dev = _val(src).device if isinstance(src, torch.fx.Node) \
            and isinstance(_val(src), torch.Tensor) else None
        if name in _HOST_SYNC:
            findings.append(Finding(
                pass_name="graph/no-host-sync", severity="error",
                op=f"{name} {node.name}", bytes=_nbytes(node),
                hint="a device value read on the host inside the step "
                     "stalls the device every launch; keep it on device",
                where=where, step=step_name,
            ))
        elif ns not in _DEVICE_NAMESPACES:
            findings.append(Finding(
                pass_name="graph/no-host-sync", severity="warning",
                op=f"custom op {ns}::{name} {node.name}", bytes=_nbytes(node),
                hint="op outside the port's own namespace; verify it stays "
                     "on-device (extend _DEVICE_NAMESPACES if so)",
                where=where, step=step_name,
            ))
        elif name in ("_to_copy", "to", "copy", "copy_") and src_dev is not None \
                and src_dev.type != "cpu" and any(
                    v.device.type == "cpu" for v in _vals(node)):
            findings.append(Finding(
                pass_name="graph/no-host-sync", severity="error",
                op=f"{name} {node.name} -> cpu", bytes=_nbytes(node),
                hint="a copy to the host inside the step stalls the device "
                     "every launch; return the value and copy after the step",
                where=where, step=step_name,
            ))
        elif _dtype(node) == torch.float64 and isinstance(src, torch.fx.Node) \
                and _dtype(src) not in (None, torch.float64):
            findings.append(Finding(
                pass_name="graph/no-host-sync", severity="error",
                op=f"{name} {node.name} -> {_type_str(node)}",
                bytes=_nbytes(node),
                hint="f64 escape in the step graph — usually a stray "
                     "Python float or an explicit double promoting the chain",
                where=where, step=step_name,
            ))
    return findings


_NARROW_INTS = (torch.int8, torch.uint8, torch.int16, torch.int32)


def dtype_discipline(gm: Any, step_name: str = "",
                     acc_bits: int = 32) -> List[Finding]:
    """Softmax accumulates in f32; DA accumulators stay within 32 bits."""
    findings: List[Finding] = []
    wide_ints = (torch.int64, torch.uint64) if hasattr(torch, "uint64") \
        else (torch.int64,)
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = _op_name(node)
        if name is None or port_op_name(node) is not None:
            continue
        dtypes = {v.dtype for v in _vals(node)}
        where = _where(node)
        ins = [a for a in _node_args(node) if isinstance(a, torch.fx.Node)]
        in_dtypes = {_dtype(a) for a in ins}
        if name in _EXP and dtypes & {torch.float16, torch.bfloat16}:
            findings.append(Finding(
                pass_name="graph/dtype-discipline", severity="error",
                op=f"{name} {node.name} ({_type_str(node)})",
                bytes=_nbytes(node),
                hint="softmax must exponentiate/accumulate in f32 — "
                     "sub-f32 exp breaks the fused==gather bit-identity",
                where=where, step=step_name,
            ))
        elif name in _DOTS and (dtypes | in_dtypes) & set(wide_ints):
            findings.append(Finding(
                pass_name="graph/dtype-discipline", severity="error",
                op=f"{name} {node.name} ({_type_str(node)})",
                bytes=_nbytes(node),
                hint=f"DA accumulator widened past acc_bits={acc_bits} "
                     "(64-bit dot) — the shift-add chain silently "
                     "outgrew its hardware accumulator",
                where=where, step=step_name,
            ))
        elif torch.float64 in dtypes or torch.complex128 in dtypes or (
                name in _ACCUMULATE and dtypes & set(wide_ints)
                and in_dtypes & set(_NARROW_INTS)):
            findings.append(Finding(
                pass_name="graph/dtype-discipline", severity="error",
                op=f"{name} {node.name} ({_type_str(node)})",
                bytes=_nbytes(node),
                hint="64-bit value in the step graph; the serving stack "
                     "is 32-bit end to end (int64 indices aside)",
                where=where, step=step_name,
            ))
    return findings


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def _allowed(f: Finding, tok: str) -> bool:
    scope, at, sub = tok.partition("@")
    if at and scope.startswith(("graph/", "lint/", "races/")):
        return f.pass_name == scope and (sub in f.where or sub in f.op)
    return tok in f.where or tok in f.op


def apply_allowlist(findings: Sequence[Finding],
                    allow: Sequence[str]) -> List[Finding]:
    """Drop findings whose ``where``/``op`` matches an allowlist entry (the
    reference's rule); an entry ``PASS@SUBSTR`` matches only that pass's
    findings."""
    if not allow:
        return list(findings)
    return [f for f in findings if not any(_allowed(f, tok) for tok in allow)]


def run_passes(steps: Sequence[Any], allow: Sequence[str] = DEFAULT_ALLOWLIST,
               acc_bits: int = 32) -> List[Finding]:
    """Run the full pass pipeline over traced steps (see
    :func:`repro_torch.analysis.graph.trace_serving_steps`)."""
    findings: List[Finding] = []
    for step in steps:
        findings += multiplier_free(step.gm, step.arg_taints, step_name=step.name)
        if step.fused:
            findings += no_big_gather(step.gm, step.view_bytes, step_name=step.name,
                                      pools=step.pools)
        findings += no_host_sync(step.gm, step_name=step.name)
        findings += dtype_discipline(step.gm, step_name=step.name,
                                     acc_bits=acc_bits)
    return apply_allowlist(findings, allow)
