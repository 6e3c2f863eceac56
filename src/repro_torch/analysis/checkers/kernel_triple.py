"""RPA008: kernel-triple conformance.

Every kernel of the port lives in ``repro_torch/kernels/<name>/`` as a
triple, the reference's layout:

* ``kernel.py`` — the Hopper kernel's binding (public entry carries an
  accelerator suffix: ``_cuda``, or the reference's ``_fwd``/``_tpu``/
  ``_pallas``);
* ``ref.py``    — the plain PyTorch oracle (``*_ref``), importable
  without the kernel: parity tests must be able to trust it as an
  independent witness, so ``ref.py`` must not import ``kernel``/``ops``;
* ``ops.py``    — the public dispatch (may import both).

Layering: ``kernel.py`` must not import ``ops.py`` (the dispatch sits
on top).  Signature conformance: for every public ops function ``X``
with an oracle ``X_ref``, the parameter names the two share must appear
in the same relative order (a transposed or renamed argument between
dispatch and oracle is how a parity test silently starts comparing the
wrong thing); the first positional parameter must match exactly.  The
same check runs against ``X_<accel-suffix>`` kernels (``X_cuda``).

Dispatch: a CUDA tensor launches the kernel or raises. In ``ops.py`` no
``try`` whose body calls into ``kernel.py`` may have a handler that
calls a ``*_ref`` oracle (or anything of ``ref.py``): such a fallback
would hide a kernel that fails to build or launch behind the plain
version's answer.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.analysis.core import (
    Checker,
    Finding,
    ModuleInfo,
    dotted_name,
    enclosing_symbols,
    import_aliases,
)

_TRIPLE = ("kernel.py", "ref.py", "ops.py")
_ACCEL_SUFFIXES = ("_cuda", "_fwd", "_tpu", "_pallas", "_kernel", "_xla")


def _kernel_packages(
    modules: Sequence[ModuleInfo],
) -> Dict[str, Dict[str, ModuleInfo]]:
    """``{package-dir: {filename: module}}`` for kernels/<name>/ dirs."""
    out: Dict[str, Dict[str, ModuleInfo]] = {}
    for mod in modules:
        parts = mod.pkg_parts
        if (
            len(parts) == 4
            and parts[0] == "repro_torch"
            and parts[1] == "kernels"
            and parts[3].endswith(".py")
        ):
            pkg_dir = mod.path.rsplit("/", 1)[0]
            out.setdefault(pkg_dir, {})[parts[3]] = mod
    return out


def _public_fns(mod: ModuleInfo) -> Dict[str, ast.FunctionDef]:
    return {
        node.name: node
        for node in mod.tree.body
        if isinstance(node, ast.FunctionDef)
        and not node.name.startswith("_")
    }


def _positional_names(fn: ast.FunctionDef) -> List[str]:
    args = fn.args
    return [a.arg for a in list(args.posonlyargs) + list(args.args)]


def _all_param_names(fn: ast.FunctionDef) -> List[str]:
    args = fn.args
    return [
        a.arg
        for a in list(args.posonlyargs) + list(args.args)
        + list(args.kwonlyargs)
    ]


def _imports_sibling(mod: ModuleInfo, sibling: str) -> Optional[ast.AST]:
    """Import node when ``mod`` imports the named sibling module of the
    same kernel package (absolute or relative form)."""
    pkg = ".".join(mod.pkg_parts[:-1])  # e.g. repro_torch.kernels.traffic
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == f"{pkg}.{sibling}":
                    return node
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level:  # relative: from . import kernel / from .kernel
                if module == sibling or (
                    module == "" and any(
                        a.name == sibling for a in node.names
                    )
                ):
                    return node
            elif module == f"{pkg}.{sibling}":
                return node
            elif module == pkg and any(
                a.name == sibling for a in node.names
            ):
                return node
    return None


def _sibling_names(mod: ModuleInfo, sibling: str) -> Tuple[set, set]:
    """``(module aliases, function names)`` through which ``mod`` reaches
    the named sibling of its kernel package: ``_kernel`` for ``from
    repro_torch.kernels.x import kernel as _kernel``, ``f`` for ``from
    repro_torch.kernels.x.kernel import f`` (relative forms included)."""
    pkg = ".".join(mod.pkg_parts[:-1])
    full = f"{pkg}.{sibling}"
    modules, names = set(), set()
    for local, path in import_aliases(mod.tree).items():
        if path == full:
            modules.add(local)
        elif path.startswith(full + "."):
            names.add(local)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            for a in node.names:
                if node.module == sibling:
                    names.add(a.asname or a.name)
                elif not node.module and a.name == sibling:
                    modules.add(a.asname or a.name)
    return modules, names


def _calls_into(
    stmts: Sequence[ast.AST], modules: set, names: set
) -> Optional[ast.Call]:
    """First call in ``stmts`` into a sibling reached as ``modules`` /
    ``names``."""
    for stmt in stmts:
        for n in ast.walk(stmt):
            if not isinstance(n, ast.Call):
                continue
            dn = dotted_name(n.func) or ""
            head = dn.split(".", 1)[0]
            if (head in modules and "." in dn) or dn in names:
                return n
    return None


def _order_conflict(
    ops_params: List[str], other_params: List[str]
) -> Optional[Tuple[str, str]]:
    """First pair of shared parameter names whose relative order differs."""
    shared = [p for p in ops_params if p in other_params]
    pos = {p: other_params.index(p) for p in shared}
    for i in range(1, len(shared)):
        if pos[shared[i]] < pos[shared[i - 1]]:
            return shared[i - 1], shared[i]
    return None


class KernelTripleChecker(Checker):
    code = "RPA008"
    name = "kernel-triple"
    description = (
        "every kernels/<name>/ package must ship the "
        "kernel.py/ref.py/ops.py triple with layered imports and "
        "order-consistent public signatures"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        for pkg_dir, files in sorted(_kernel_packages(modules).items()):
            if "__init__.py" not in files:
                continue
            init = files["__init__.py"]
            for required in _TRIPLE:
                if required not in files:
                    yield self.finding(
                        init, init.tree,
                        f"kernel package {pkg_dir} is missing "
                        f"{required} — every kernel ships the "
                        f"kernel/ref/ops triple",
                    )
            if not all(f in files for f in _TRIPLE):
                continue
            yield from self._check_triple(pkg_dir, files)

    def _check_triple(
        self, pkg_dir: str, files: Dict[str, ModuleInfo]
    ) -> Iterator[Finding]:
        ref, kernel, ops = files["ref.py"], files["kernel.py"], files["ops.py"]

        for sibling in ("kernel", "ops"):
            node = _imports_sibling(ref, sibling)
            if node is not None:
                yield self.finding(
                    ref, node,
                    f"ref.py imports {sibling}.py — the oracle must stay "
                    f"an independent witness (parity tests lose their "
                    f"meaning if the reference shares kernel code)",
                )
        node = _imports_sibling(kernel, "ops")
        if node is not None:
            yield self.finding(
                kernel, node,
                "kernel.py imports ops.py — the dispatch layer sits on "
                "top of the kernel, not under it",
            )

        ref_fns = _public_fns(ref)
        kernel_fns = _public_fns(kernel)
        ops_fns = _public_fns(ops)
        if not any(n.endswith("_ref") for n in ref_fns):
            yield self.finding(
                ref, ref.tree,
                f"ref.py in {pkg_dir} defines no public *_ref oracle",
            )
        if not any(
            n.endswith(_ACCEL_SUFFIXES) for n in kernel_fns
        ):
            yield self.finding(
                kernel, kernel.tree,
                f"kernel.py in {pkg_dir} defines no public accelerator "
                f"entry (*_cuda/*_fwd/*_tpu/*_pallas)",
            )
        if not ops_fns:
            yield self.finding(
                ops, ops.tree,
                f"ops.py in {pkg_dir} defines no public dispatch function",
            )

        yield from self._check_dispatch(ops)

        for name, ops_fn in sorted(ops_fns.items()):
            counterparts = [(f"{name}_ref", ref, ref_fns.get(f"{name}_ref"))]
            counterparts += [
                (f"{name}{suf}", kernel, kernel_fns.get(f"{name}{suf}"))
                for suf in _ACCEL_SUFFIXES
            ]
            for other_name, other_mod, other_fn in counterparts:
                if other_fn is None:
                    continue
                # kw-only parameters are order-free by construction, so
                # conformance is judged on positional parameters only
                ops_pos = _positional_names(ops_fn)
                other_pos = _positional_names(other_fn)
                if (
                    ops_pos
                    and other_pos
                    and ops_pos[0] != other_pos[0]
                ):
                    yield self.finding(
                        other_mod, other_fn,
                        f"{other_name} leads with parameter "
                        f"`{other_pos[0]}` but dispatch {name} leads "
                        f"with `{ops_pos[0]}` — triple signatures must "
                        f"agree on the primary operand",
                        other_name,
                    )
                conflict = _order_conflict(ops_pos, other_pos)
                if conflict is not None:
                    a, b = conflict
                    yield self.finding(
                        other_mod, other_fn,
                        f"{other_name} orders shared parameters "
                        f"`{b}` before `{a}` but dispatch {name} passes "
                        f"`{a}` before `{b}` — transposed triple "
                        f"signatures silently break parity",
                        other_name,
                    )

    def _check_dispatch(self, ops: ModuleInfo) -> Iterator[Finding]:
        kernel_mods, kernel_names = _sibling_names(ops, "kernel")
        ref_mods, ref_names = _sibling_names(ops, "ref")
        symbols = enclosing_symbols(ops.tree)
        for node in ast.walk(ops.tree):
            if not isinstance(node, ast.Try):
                continue
            if _calls_into(node.body, kernel_mods, kernel_names) is None:
                continue
            for handler in node.handlers:
                for n in ast.walk(handler):
                    if not isinstance(n, ast.Call):
                        continue
                    dn = dotted_name(n.func) or ""
                    if not (
                        dn.endswith("_ref")
                        or _calls_into([n], ref_mods, ref_names) is not None
                    ):
                        continue
                    yield self.finding(
                        ops, n,
                        f"ops.py falls back to the plain version `{dn}` "
                        f"when the kernel raises — a CUDA tensor must "
                        f"launch the kernel or raise, so a kernel that "
                        f"fails to build or launch cannot hide",
                        symbols.get(node, "<module>"),
                    )
