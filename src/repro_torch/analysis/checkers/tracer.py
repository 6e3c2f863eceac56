"""RPA005: no host syncs where the card dispatches or the dry run traces.

The reference flags host syncs in code traced under ``jit``/``lax``/
``pallas_call``. The port's counterpart is code that runs on the card's
stream without a copy back, and that the dry run traces under fake
tensors (``launch/dryrun.py``): a host sync there stalls the card every
call, and on a fake tensor it raises (the dry run's first train cell
on the card hit ``int(step)`` on a fake tensor). Roots are discovered
structurally, per module ``kernels/<name>/{kernel,ops,ref}.py``:

* the methods of ``torch.autograd.Function`` subclasses (the K4/K5/K6
  forwards and backwards);
* the bodies of ``torch.library.custom_op`` operators and their
  ``register_fake`` (and ``register_kernel``/``register_autograd``)
  implementations, and callables wrapped by ``torch.vmap``/
  ``torch.compile``/``torch.func.*``/``torch.jit.*``;
* the public ``*_cuda`` entries;
* the public ``*_ref`` oracles, as in the reference (the backwards
  recompute them under autograd, so the dry run traces them);

plus every same-module function they call (nested defs included).
Inside those bodies the rule flags ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``.synchronize()`` and
``torch.cuda.synchronize()``, ``torch.equal``/``allclose``/
``is_nonzero``, ``float()``/``int()``/``bool()`` and ``np.asarray``/
``np.array`` of a tensor-valued expression, and a Python ``if``,
``while``, conditional expression or ``assert`` on a tensor-valued
predicate.

A name is tensor-valued when it is a parameter (not annotated ``int``,
``float``, ``bool``, ``str`` or ``bytes``) used as an operand of a
``torch.`` function (sizes, dims, dtypes and devices of factories and
keyword options are not operands) or as the receiver of a tensor
method, or a local bound to a tensor-valued expression. Static
accessors are fine: ``.shape``, ``.dim()``, ``.dtype``, ``.device``,
``.is_cuda``, ``.numel()``, ``len``, ``isinstance``, ``is None``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from repro_torch.analysis.core import (
    Checker,
    Finding,
    ModuleInfo,
    dotted_name,
    own_nodes,
    paired_targets,
    resolve_call_target,
    resolve_dotted,
    walk_functions,
)

_TRACED_FILES = ("kernel.py", "ops.py", "ref.py")
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "bytes"}

#: decorators (last attribute) that make a function an operator body
_OP_DECORATORS = {
    "custom_op", "register_fake", "register_kernel", "impl_abstract",
    "triton_op",
}
#: calls (last attribute) whose callable arguments the card dispatches
_OP_REGISTRATIONS = {"register_autograd", "register_fake",
                     "register_kernel"}
_WRAPPER_PREFIXES = ("torch.func.", "torch.jit.")
_WRAPPERS = {"torch.vmap", "torch.compile"}

_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize",
                      "equal", "allclose", "is_nonzero"}
_HOST_SYNC_CALLS = {"torch.cuda.synchronize", "torch.equal",
                    "torch.allclose", "torch.is_nonzero"}
_NP_HOST_CALLS = {"asarray", "array", "ascontiguousarray", "copyto"}

#: torch functions that take sizes, dims, dtypes or devices, or answer a
#: host-side question: their arguments are not tensor operands and their
#: results (factories aside) are not tensors
_TORCH_META = {
    "device", "dtype", "Size", "Generator", "finfo", "iinfo",
    "promote_types", "result_type", "broadcast_shapes", "can_cast",
    "get_default_dtype", "is_tensor", "is_floating_point", "is_complex",
    "is_grad_enabled", "is_inference_mode_enabled", "enable_grad",
    "no_grad", "inference_mode", "set_grad_enabled", "numel",
}
_TORCH_FACTORIES = {
    "empty", "zeros", "ones", "full", "arange", "linspace", "logspace",
    "eye", "empty_strided", "tensor", "as_tensor", "scalar_tensor",
    "rand", "randn", "randint", "randperm",
}
_OPTION_KEYWORDS = {
    "dim", "dims", "size", "dtype", "device", "layout", "generator",
    "memory_format", "requires_grad", "pin_memory", "shifts", "diagonal",
    "keepdim", "out", "descending", "stable", "sorted", "return_counts",
    "steps", "non_blocking", "copy", "equation",
}
#: tensor methods: a receiver is tensor-valued, and so is the result
_TENSOR_METHODS = {
    "sum", "mean", "any", "all", "cumsum", "cumprod", "prod", "abs",
    "clamp", "clamp_", "float", "double", "half", "bfloat16", "long",
    "to", "view", "reshape", "contiguous", "unsqueeze", "squeeze",
    "masked_fill", "masked_fill_", "exp", "log", "sqrt", "rsqrt",
    "sigmoid", "tanh", "softmax", "matmul", "transpose", "permute",
    "flatten", "expand", "gather", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "index_select", "index_add_", "narrow", "argmax",
    "argmin", "amax", "amin", "argsort", "topk", "nonzero",
    "count_nonzero", "new_empty", "new_zeros", "new_full", "new_ones",
    "zero_", "fill_", "copy_", "add_", "mul_", "detach", "clone",
    "type_as", "view_as", "reshape_as", "expand_as", "neg", "floor",
    "ceil", "round", "maximum", "minimum", "logical_and", "logical_or",
    "logical_not", "isfinite", "isnan", "requires_grad_", "split",
    "chunk", "unbind", "cuda", "max", "min", "norm", "var", "std",
    "mm", "bmm",
}
def _callable_names(node: ast.AST) -> List[str]:
    """Plain function names referenced by an expression (Name or
    functools.partial(Name, …))."""
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Call):
        fn = dotted_name(node.func) or ""
        if fn.endswith("partial"):
            out: List[str] = []
            for a in node.args:
                out.extend(_callable_names(a))
            return out
    return []


class _Unit:
    """One function: its node, qualname and same-module callees."""

    def __init__(self, qual: str, node: ast.AST) -> None:
        self.qual = qual
        self.node = node
        self.calls: Set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                self.calls.add(n.func.id)


class _Values:
    """Which names of one function hold tensors."""

    def __init__(self, fn: ast.AST, aliases: Dict[str, str]) -> None:
        self.aliases = aliases
        self.names: Set[str] = set()
        params = []
        args = fn.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            if a.arg in ("self", "cls", "ctx"):
                continue
            ann = a.annotation
            if isinstance(ann, ast.Name) and ann.id in _SCALAR_ANNOTATIONS:
                continue
            params.append(a.arg)
        nodes = list(own_nodes(fn))
        for n in nodes:
            if isinstance(n, ast.Call):
                for operand in self._operands(n):
                    if isinstance(operand, ast.Name) and operand.id in params:
                        self.names.add(operand.id)
        changed = True
        while changed:
            changed = False
            for n in nodes:
                for name in self._bound_tensors(n):
                    if name not in self.names:
                        self.names.add(name)
                        changed = True

    def _torch_fn(self, call: ast.Call) -> Optional[str]:
        target = resolve_call_target(call, self.aliases) or ""
        return target if target.startswith("torch.") else None

    def _operands(self, call: ast.Call) -> Iterator[ast.AST]:
        """Expressions a call uses as tensor operands."""
        target = self._torch_fn(call)
        if target is not None:
            leaf = target.rsplit(".", 1)[-1]
            if (leaf in _TORCH_META or leaf in _TORCH_FACTORIES
                    or target.startswith(("torch.cuda.", "torch.library.",
                                          "torch.autograd.",
                                          "torch.backends."))):
                return
            for a in call.args:
                yield from self._leaves(a)
            for kw in call.keywords:
                if kw.arg not in _OPTION_KEYWORDS:
                    yield from self._leaves(kw.value)
        elif (isinstance(call.func, ast.Attribute)
              and call.func.attr in _TENSOR_METHODS):
            yield call.func.value

    def _leaves(self, expr: ast.AST) -> Iterator[ast.AST]:
        """Operand names of an argument: itself, or the sides of its
        arithmetic (``x * y`` uses both)."""
        if isinstance(expr, ast.BinOp):
            yield from self._leaves(expr.left)
            yield from self._leaves(expr.right)
        elif isinstance(expr, ast.UnaryOp):
            yield from self._leaves(expr.operand)
        elif isinstance(expr, (ast.Tuple, ast.List)):
            for elt in expr.elts:
                yield from self._leaves(elt)
        elif isinstance(expr, ast.Starred):
            yield from self._leaves(expr.value)
        else:
            yield expr

    def _bound_tensors(self, n: ast.AST) -> Iterator[str]:
        if isinstance(n, ast.NamedExpr):
            if self.tensor(n.value):
                yield n.target.id
            return
        for t, v in paired_targets(n):
            if isinstance(t, ast.Name) and self.tensor(v):
                yield t.id

    def tensor(self, expr: Optional[ast.AST]) -> bool:
        """True when ``expr`` evaluates to a tensor."""
        if expr is None:
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, ast.Call):
            target = self._torch_fn(expr)
            if target is not None:
                leaf = target.rsplit(".", 1)[-1]
                return not (
                    leaf in _TORCH_META
                    or target.startswith(("torch.cuda.", "torch.library.",
                                          "torch.backends."))
                    or target in _HOST_SYNC_CALLS
                )
            if (isinstance(expr.func, ast.Attribute)
                    and expr.func.attr in _TENSOR_METHODS):
                return self.tensor(expr.func.value)
            return False
        if isinstance(expr, ast.BinOp):
            return self.tensor(expr.left) or self.tensor(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.tensor(expr.operand)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in expr.ops):
                return False
            return any(self.tensor(e)
                       for e in [expr.left, *expr.comparators])
        if isinstance(expr, ast.BoolOp):
            return any(self.tensor(v) for v in expr.values)
        if isinstance(expr, ast.Subscript):
            return self.tensor(expr.value)
        if isinstance(expr, ast.IfExp):
            return self.tensor(expr.body) or self.tensor(expr.orelse)
        if isinstance(expr, ast.Attribute):
            return expr.attr in ("T", "mT", "H", "real", "imag", "data",
                                 "grad") and self.tensor(expr.value)
        return False


class TracerPurityChecker(Checker):
    code = "RPA005"
    name = "host-sync-purity"
    description = (
        "code the card dispatches or the dry run traces under fake "
        "tensors must not host-sync (.item(), .cpu(), float()/int() of a "
        "tensor, Python branches on tensors)"
    )

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        parts = mod.pkg_parts
        if not (mod.in_package("kernels") and len(parts) == 4
                and parts[3] in _TRACED_FILES):
            return
        aliases = mod.aliases
        units = [_Unit(q, n) for q, n in walk_functions(mod.tree)]
        roots = self._find_roots(mod, units, aliases)
        for i in sorted(self._reach(roots, units)):
            yield from self._check_body(mod, units[i], mod.symbols, aliases)

    # -- root discovery ----------------------------------------------------

    def _find_roots(
        self, mod: ModuleInfo, units: List[_Unit], aliases
    ) -> Set[int]:
        roots: Set[int] = set()
        by_name: Dict[str, List[int]] = {}
        for i, u in enumerate(units):
            by_name.setdefault(u.qual.rsplit(".", 1)[-1], []).append(i)

        def add_names(expr: ast.AST) -> None:
            for name in _callable_names(expr):
                roots.update(by_name.get(name, []))

        functions = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and any(
                (resolve_dotted(b, aliases) or "").endswith(
                    "autograd.Function")
                for b in node.bases
            ):
                functions.update(
                    id(f) for f in node.body
                    if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                )
        for i, u in enumerate(units):
            name = u.qual.rsplit(".", 1)[-1]
            if id(u.node) in functions:
                roots.add(i)
            if name.endswith(("_ref", "_cuda")) and not name.startswith("_"):
                roots.add(i)
            for dec in getattr(u.node, "decorator_list", []):
                head = dec.func if isinstance(dec, ast.Call) else dec
                target = resolve_dotted(head, aliases) or ""
                if (target.rsplit(".", 1)[-1] in _OP_DECORATORS
                        or target in _WRAPPERS
                        or target.startswith(_WRAPPER_PREFIXES)):
                    roots.add(i)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            target = resolve_call_target(node, aliases) or ""
            leaf = target.rsplit(".", 1)[-1]
            if (leaf in _OP_REGISTRATIONS or target in _WRAPPERS
                    or target.startswith(_WRAPPER_PREFIXES)):
                for a in list(node.args) + [kw.value for kw in node.keywords]:
                    add_names(a)
        return roots

    def _reach(self, roots: Set[int], units: List[_Unit]) -> Set[int]:
        by_name: Dict[str, List[int]] = {}
        for i, u in enumerate(units):
            by_name.setdefault(u.qual.rsplit(".", 1)[-1], []).append(i)
        seen: Set[int] = set()
        stack = sorted(roots)
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            # nested defs run with their parent
            prefix = units[i].qual + "."
            for j, other in enumerate(units):
                rest = other.qual[len(prefix):]
                if other.qual.startswith(prefix) and "." not in rest:
                    stack.append(j)
            for callee in units[i].calls:
                stack.extend(by_name.get(callee, []))
        return seen

    # -- body rules --------------------------------------------------------

    def _check_body(
        self, mod: ModuleInfo, unit: _Unit, symbols, aliases
    ) -> Iterator[Finding]:
        values = _Values(unit.node, aliases)
        for n in own_nodes(unit.node):
            symbol = symbols.get(n, unit.qual)
            if isinstance(n, ast.Call):
                message = self._sync_call(n, values, aliases)
                if message:
                    yield self.finding(mod, n, message, symbol)
            elif isinstance(n, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                if values.tensor(n.test):
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "conditional expression",
                            ast.Assert: "assert"}[type(n)]
                    yield self.finding(
                        mod, n.test,
                        f"Python `{kind}` on a tensor forces a host sync "
                        f"(and fails on a fake tensor) — use torch.where "
                        f"or keep the decision on the device",
                        symbol,
                    )

    def _sync_call(
        self, n: ast.Call, values: _Values, aliases
    ) -> Optional[str]:
        target = resolve_call_target(n, aliases) or ""
        if target in _HOST_SYNC_CALLS:
            return (f"`{target}()` waits for the card — a host sync "
                    f"where the card dispatches or the dry run traces")
        if isinstance(n.func, ast.Attribute):
            attr = n.func.attr
            if attr in _HOST_SYNC_METHODS:
                return (f"`.{attr}()` forces a host sync — illegal where "
                        f"the card dispatches or the dry run traces")
            if attr == "to" and any(
                isinstance(a, ast.Constant) and a.value == "cpu"
                for a in list(n.args) + [kw.value for kw in n.keywords]
            ):
                return ("`.to(\"cpu\")` copies to the host — a host sync "
                        "where the card dispatches or the dry run traces")
        if target in ("float", "int", "bool") and n.args:
            if values.tensor(n.args[0]):
                return (f"builtin `{target}()` of a tensor forces a host "
                        f"scalar (and fails on a fake tensor)")
        if (target.startswith(("np.", "numpy."))
                and target.rsplit(".", 1)[-1] in _NP_HOST_CALLS
                and n.args and values.tensor(n.args[0])):
            return (f"`{target}` of a tensor copies it to the host — keep "
                    f"it a tensor")
        return None
