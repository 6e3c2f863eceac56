"""RPA004: ambient precision and default flips.

The reference flags ambient ``jax_enable_x64`` flips: an ambient flip
changes dtypes, and so bits, for every other program in the process.
The port's counterparts are torch's process-wide precision and default
switches. A flip changes every later product, convolution or factory
call in the process, the pinned float32 paths included. This rule flags
every ambient flip:

* calls to ``torch.set_default_dtype``, ``set_default_tensor_type``,
  ``set_default_device`` and ``set_float32_matmul_precision``;
* stores to ``torch.backends.cuda.matmul.allow_tf32``,
  ``torch.backends.cudnn.allow_tf32``,
  ``torch.backends.cuda.matmul.allow_{fp16,bf16}_reduced_precision_reduction``
  and any ``torch.backends…fp32_precision`` (through any import alias,
  ``setattr`` included);
* stores of ``NVIDIA_TF32_OVERRIDE`` / ``TORCH_ALLOW_TF32_CUBLAS_OVERRIDE``
  into ``os.environ`` (subscript, ``setdefault``, ``update``) or through
  ``os.putenv``.

The scoped form is allowed, as ``enable_x64()`` is in the reference: a
``contextlib.contextmanager`` whose ``try`` yields and whose ``finally``
restores every flag the function sets (a store of a saved value, not a
literal; for a default, the same setter called again; for the
environment, a store, ``pop`` or ``del``). Reads of the flags are
allowed.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import (
    Checker,
    Finding,
    ModuleInfo,
    own_nodes,
    paired_targets,
    resolve_call_target,
    resolve_dotted,
    walk_functions,
)

_DEFAULT_SETTERS = {
    "torch.set_default_dtype", "torch.set_default_tensor_type",
    "torch.set_default_device", "torch.set_float32_matmul_precision",
}

_FLAG_SUFFIXES = (
    "cuda.matmul.allow_tf32",
    "cudnn.allow_tf32",
    "cuda.matmul.allow_fp16_reduced_precision_reduction",
    "cuda.matmul.allow_bf16_reduced_precision_reduction",
)

_ENV_VARS = {"NVIDIA_TF32_OVERRIDE", "TORCH_ALLOW_TF32_CUBLAS_OVERRIDE"}


#: the last names of the calls that can flip a switch (a cheap filter)
_CALL_LEAVES = {
    *(name.rsplit(".", 1)[-1] for name in _DEFAULT_SETTERS),
    "setattr", "putenv", "setdefault", "pop", "update",
}


def _leaf(func: ast.AST, aliases) -> str:
    """The last name of a call's target, through import aliases."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return aliases.get(func.id, func.id).rsplit(".", 1)[-1]
    return ""


def _const_str(node: Optional[ast.AST]) -> str:
    return node.value if isinstance(node, ast.Constant) and isinstance(
        node.value, str
    ) else ""


def _is_flag(name: str) -> bool:
    if name.endswith(_FLAG_SUFFIXES):
        return True
    return name.startswith("torch.backends") and name.endswith(
        "fp32_precision"
    )


def _is_environ(node: ast.AST, aliases) -> bool:
    name = resolve_dotted(node, aliases) or ""
    return name == "os.environ"


def _flips(node: ast.AST, aliases) -> List[Tuple[str, ast.AST, bool]]:
    """``(key, anchor, is_restore_shaped)`` for each ambient flip that
    ``node`` makes. ``key`` names the switch; a flip is restore-shaped
    when it could put a saved value back (not a literal)."""
    out: List[Tuple[str, ast.AST, bool]] = []
    for target, value in paired_targets(node):
        name = resolve_dotted(target, aliases) or ""
        saved = not isinstance(value, ast.Constant)
        if _is_flag(name):
            out.append((name, target, saved))
        elif (
            isinstance(target, ast.Subscript)
            and _is_environ(target.value, aliases)
            and _const_str(target.slice) in _ENV_VARS
        ):
            out.append((f"env:{_const_str(target.slice)}", target, saved))
    if isinstance(node, ast.Delete):
        for target in node.targets:
            if (
                isinstance(target, ast.Subscript)
                and _is_environ(target.value, aliases)
                and _const_str(target.slice) in _ENV_VARS
            ):
                out.append((f"env:{_const_str(target.slice)}", target, True))
    if isinstance(node, ast.Call) and _leaf(node.func, aliases) in _CALL_LEAVES:
        fn = resolve_call_target(node, aliases) or ""
        first = _const_str(node.args[0]) if node.args else ""
        saved = bool(node.args) and not isinstance(node.args[0], ast.Constant)
        if fn in _DEFAULT_SETTERS:
            out.append((fn, node, saved))
        elif fn in ("setattr", "builtins.setattr") and len(node.args) >= 2:
            name = f"{resolve_dotted(node.args[0], aliases) or ''}." \
                   f"{_const_str(node.args[1])}"
            if _is_flag(name):
                value = node.args[2] if len(node.args) > 2 else None
                out.append((name, node, not isinstance(value, ast.Constant)))
        elif fn in ("os.putenv", "putenv") and first in _ENV_VARS:
            out.append((f"env:{first}", node, saved))
        elif (
            isinstance(node.func, ast.Attribute)
            and _is_environ(node.func.value, aliases)
        ):
            attr = node.func.attr
            if attr in ("setdefault", "pop") and first in _ENV_VARS:
                out.append((f"env:{first}", node, attr == "pop"))
            elif attr == "update":
                keys = [
                    _const_str(k) for a in node.args
                    if isinstance(a, ast.Dict) for k in a.keys
                ] + [kw.arg for kw in node.keywords]
                for key in keys:
                    if key in _ENV_VARS:
                        out.append((f"env:{key}", node, False))
    return out


def _is_contextmanager(fn: ast.AST, aliases) -> bool:
    for dec in getattr(fn, "decorator_list", []):
        name = resolve_dotted(dec, aliases) or ""
        if name.rsplit(".", 1)[-1] in ("contextmanager",
                                        "asynccontextmanager"):
            return True
    return False


def _scoped_flips(fn: ast.AST, aliases) -> Set[int]:
    """ids of the flip anchors a context manager scopes: every flip in a
    ``try`` that yields, or before it, whose key the ``finally``
    restores from a saved value; and the restores themselves."""
    if not _is_contextmanager(fn, aliases):
        return set()
    scoped: Set[int] = set()
    for node in own_nodes(fn):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        if not any(
            isinstance(n, (ast.Yield, ast.YieldFrom))
            for stmt in node.body for n in ast.walk(stmt)
        ):
            continue
        restored: Set[str] = set()
        restores: Set[int] = set()
        for stmt in node.finalbody:
            for n in ast.walk(stmt):
                for key, anchor, saved in _flips(n, aliases):
                    if saved:
                        restored.add(key)
                        restores.add(id(anchor))
        for n in own_nodes(fn):
            if id(n) in restores:
                continue
            for key, anchor, _ in _flips(n, aliases):
                if key in restored:
                    scoped.add(id(anchor))
        scoped |= restores
    return scoped


class X64HygieneChecker(Checker):
    code = "RPA004"
    name = "precision-hygiene"
    description = (
        "torch's process-wide precision and default switches (TF32, "
        "reduced-precision reductions, default dtype/device) must never "
        "be flipped ambiently — only inside a context manager that "
        "restores them in `finally`"
    )

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        aliases = mod.aliases
        flips = [
            (node, key, anchor)
            for node in mod.nodes
            for key, anchor, _ in _flips(node, aliases)
        ]
        if not flips:
            return
        scoped: Set[int] = set()
        for _, fn in walk_functions(mod.tree):
            scoped |= _scoped_flips(fn, aliases)
        for node, key, anchor in flips:
            if id(anchor) in scoped:
                continue
            what = key[4:] if key.startswith("env:") else key
            yield self.finding(
                mod, anchor,
                f"ambient flip of `{what}` changes precision for the "
                f"whole process — set it inside a contextmanager that "
                f"saves it and restores it in `finally`",
                mod.symbols.get(node, "<module>"),
            )
