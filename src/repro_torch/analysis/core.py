"""Checker framework: findings, module loading, registry, AST helpers.

A *checker* owns one ``RPA0xx`` code and is either per-module
(``check_module`` runs once per scanned file) or project-level
(``check_project`` runs once over the whole scan set: the stream-key
registry and the kernel-triple layout rules reason about several files
at once).

Everything here is stdlib-only by design: the pass runs without torch
or numpy installed.
"""

from __future__ import annotations

import ast
import functools
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

#: the package directory scope predicates anchor on
PACKAGE = "repro_torch"


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation, addressable for baseline suppression.

    ``symbol`` is the enclosing function/class qualname (``"<module>"``
    at top level): baselines match on ``(code, path-suffix, symbol)``
    so entries survive unrelated line drift.
    """

    path: str
    line: int
    col: int
    code: str
    symbol: str
    message: str

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


@dataclass
class ModuleInfo:
    """A parsed source file plus the path metadata checkers scope on."""

    path: str                      # path as scanned (posix separators)
    tree: ast.Module
    source: str
    lines: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.lines:
            self.lines = self.source.splitlines()

    # the per-file views every checker shares, each built once, on first
    # use: walking a tree is most of a pass's time

    @functools.cached_property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree, in ``ast.walk`` order."""
        return list(ast.walk(self.tree))

    @functools.cached_property
    def aliases(self) -> Dict[str, str]:
        """:func:`import_aliases` of the tree."""
        return import_aliases(self.tree)

    @functools.cached_property
    def symbols(self) -> Dict[ast.AST, str]:
        """:func:`enclosing_symbols` of the tree."""
        return enclosing_symbols(self.tree)

    @property
    def pkg_parts(self) -> Tuple[str, ...]:
        """Path parts from the last ``repro_torch`` component on (falls
        back to the full path): the unit scope predicates match against,
        so fixture trees shaped ``tmp/repro_torch/net/x.py`` scope like
        the real package."""
        parts = tuple(self.path.split("/"))
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] == PACKAGE:
                return parts[i:]
        return parts

    def in_port(self) -> bool:
        """True when the module lives anywhere under ``repro_torch/``."""
        parts = self.pkg_parts
        return len(parts) > 1 and parts[0] == PACKAGE

    def in_package(self, *prefixes: str) -> bool:
        """True when the module lives under any ``repro_torch/<prefix>``
        tree (a prefix may name a file: ``"fl/simulation.py"``)."""
        parts = self.pkg_parts
        if not parts or parts[0] != PACKAGE:
            return False
        return any(
            parts[1:1 + len(p.split("/"))] == tuple(p.split("/"))
            for p in prefixes
        )

    def noqa_codes(self, line: int) -> Tuple[str, ...]:
        """RPA codes named in a ``# noqa:`` comment on ``line`` (1-based)."""
        if not 1 <= line <= len(self.lines):
            return ()
        text = self.lines[line - 1]
        marker = text.find("# noqa")
        if marker < 0:
            return ()
        return tuple(
            tok for tok in text[marker:].replace(",", " ").split()
            if tok.startswith("RPA")
        )


class Checker:
    """Base class; subclasses register themselves via ``__init_subclass__``."""

    code: str = ""
    name: str = ""
    description: str = ""

    _registry: Dict[str, "type[Checker]"] = {}

    def __init_subclass__(cls, **kwargs) -> None:
        super().__init_subclass__(**kwargs)
        if cls.code:
            Checker._registry[cls.code] = cls

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        return iter(())

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        return iter(())

    def finding(
        self, mod_or_path, node: Optional[ast.AST], message: str,
        symbol: str = "<module>",
    ) -> Finding:
        path = (
            mod_or_path.path
            if isinstance(mod_or_path, ModuleInfo) else str(mod_or_path)
        )
        line = getattr(node, "lineno", 0) if node is not None else 0
        col = getattr(node, "col_offset", 0) if node is not None else 0
        return Finding(
            path=path, line=line, col=col, code=self.code,
            symbol=symbol, message=message,
        )


def all_checkers(select: Optional[Iterable[str]] = None) -> List[Checker]:
    """Instantiate every registered checker (importing the rule modules
    registers them), optionally filtered to the ``select`` codes."""
    from repro_torch.analysis import checkers as _  # noqa: F401

    codes = sorted(Checker._registry)
    if select is not None:
        want = set(select)
        unknown = want - set(codes)
        if unknown:
            raise ValueError(f"unknown rule codes: {sorted(unknown)}")
        codes = [c for c in codes if c in want]
    return [Checker._registry[c]() for c in codes]


def load_modules(paths: Sequence[str]) -> List[ModuleInfo]:
    """Parse every ``.py`` file under ``paths`` (files or directories).

    Walk order is sorted so findings, reports and registry dumps are
    byte-stable across runs and machines.
    """
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", ".ruff_cache",
                                 "_build")
                )
                files.extend(
                    os.path.join(dirpath, f)
                    for f in sorted(filenames) if f.endswith(".py")
                )
        else:
            raise FileNotFoundError(p)
    modules = []
    for f in sorted(dict.fromkeys(files)):
        with open(f, encoding="utf-8") as fh:
            source = fh.read()
        tree = ast.parse(source, filename=f)
        modules.append(ModuleInfo(path=f.replace(os.sep, "/"), tree=tree,
                                  source=source))
    return modules


def run_checkers(
    modules: Sequence[ModuleInfo],
    checkers: Optional[Sequence[Checker]] = None,
) -> List[Finding]:
    """Run every checker over the scan set; honors inline ``# noqa: RPAxxx``."""
    if checkers is None:
        checkers = all_checkers()
    findings: List[Finding] = []
    by_path = {m.path: m for m in modules}
    for checker in checkers:
        raw: List[Finding] = []
        for mod in modules:
            raw.extend(checker.check_module(mod))
        raw.extend(checker.check_project(modules))
        for f in raw:
            mod = by_path.get(f.path)
            if mod is not None and f.code in mod.noqa_codes(f.line):
                continue
            findings.append(f)
    return sorted(dict.fromkeys(findings))


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def walk_functions(
    tree: ast.Module,
) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(qualname, def-node)`` for every function/method, including
    nested ones (qualnames use ``.`` separators, methods include the
    class name)."""

    def _walk(node: ast.AST, prefix: str) -> Iterator[Tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield qual, child
                yield from _walk(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                yield from _walk(child, f"{prefix}{child.name}.")
            else:
                yield from _walk(child, prefix)

    yield from _walk(tree, "")


def enclosing_symbols(tree: ast.Module) -> Dict[ast.AST, str]:
    """Map every AST node to its enclosing function qualname (or
    ``"<module>"``): the symbol findings and baselines key on."""
    out: Dict[ast.AST, str] = {}

    def _mark(node: ast.AST, symbol: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(child, ast.ClassDef):
                _mark(child, symbol)
                continue
            out[child] = symbol
            _mark(child, symbol)

    _mark(tree, "<module>")
    for qual, fn in walk_functions(tree):
        out[fn] = out.get(fn, "<module>")
        for child in ast.iter_child_nodes(fn):
            if not isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                out[child] = qual
                _mark(child, qual)
    return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name → imported dotted path, for plain and from-imports."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def resolve_dotted(
    node: ast.AST, aliases: Dict[str, str]
) -> Optional[str]:
    """Fully-qualified dotted name of a Name/Attribute chain, through
    import aliases (``F.relu`` with ``import torch.nn.functional as F``
    → ``torch.nn.functional.relu``)."""
    dn = dotted_name(node)
    if dn is None:
        return None
    head, _, rest = dn.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def resolve_call_target(
    node: ast.Call, aliases: Dict[str, str]
) -> Optional[str]:
    """Fully-qualified dotted target of a call, through import aliases
    (``rnd.random()`` with ``import random as rnd`` → ``random.random``)."""
    return resolve_dotted(node.func, aliases)


def own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes of ``fn``'s body, not descending into nested defs, lambdas
    or classes (they are units of their own, or closures)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda, ast.ClassDef)):
            continue
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


def flat_targets(target: ast.AST) -> Iterator[ast.AST]:
    """The leaves of an assignment target (tuples and lists unpacked)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from flat_targets(elt)
    elif isinstance(target, ast.Starred):
        yield from flat_targets(target.value)
    else:
        yield target


def paired_targets(
    node: ast.AST,
) -> Iterator[Tuple[ast.AST, Optional[ast.AST]]]:
    """``(target leaf, its value)`` of an assignment statement: a tuple
    target with a tuple value of the same length pairs element by
    element, any other leaf takes the whole right-hand side. Yields
    nothing for other nodes."""
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    else:
        return
    value = node.value
    for t in targets:
        if (
            isinstance(t, (ast.Tuple, ast.List))
            and isinstance(value, (ast.Tuple, ast.List))
            and len(t.elts) == len(value.elts)
        ):
            for elt, v in zip(t.elts, value.elts):
                for leaf in flat_targets(elt):
                    yield leaf, v
        else:
            for leaf in flat_targets(t):
                yield leaf, value
