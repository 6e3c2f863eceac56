"""RPA007: collector purity — the bitwise-uninstrumented contract.

The port keeps the reference's contract: every entry point takes
``collector=None`` and a disabled collector must be *bitwise* free —
not one extra tensor op, not one state divergence. It covers every
scanned module; the port's collectors run through
``net/{engine,api,multi_pon,timeline}.py``, ``obs/``,
``fl/simulation.py`` and ``launch/train.py``. Two source-level rules
make that auditable:

* every use of a ``collector`` parameter (attribute access, method
  call) must sit under a ``collector is not None`` guard — an early
  ``if collector is None: return`` counts, as do aliases bound from
  guarded collector calls (``obs = collector.phase(...)`` →
  ``if obs is not None:`` blocks are guarded too).  Passing the bare
  ``collector`` name through to another function is always fine (the
  callee re-guards).
* inside those guarded blocks, no *engine state* may be written: any
  assignment to a name that is also bound outside guarded blocks, any
  subscript/attribute store on a non-collector object, any augmented
  assignment and any mutating method call (``.append``/``.update``/…)
  on an outside object is flagged — instrumentation must be read-only
  with respect to the simulation. Stores into tuple and list targets
  (``a, b[i] = ...``) are judged element by element. Obs-local names
  (bound only under guards) are fine.

``self._collector`` attributes follow the same rules as a ``collector``
parameter.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import (
    Checker,
    Finding,
    ModuleInfo,
    dotted_name,
    paired_targets,
    walk_functions,
)

_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "clear", "update",
    "setdefault", "popitem", "add", "discard", "sort", "reverse", "fill",
}


def _has_collector_param(fn: ast.AST) -> bool:
    args = fn.args
    return any(
        a.arg == "collector"
        for a in list(args.args) + list(args.posonlyargs)
        + list(args.kwonlyargs)
    )


def _collector_param_optional(fn: ast.AST) -> bool:
    """True when the ``collector`` parameter defaults to ``None``."""
    args = fn.args
    positional = list(args.posonlyargs) + list(args.args)
    defaults = list(args.defaults)
    # defaults align with the tail of the positional list
    offset = len(positional) - len(defaults)
    for i, a in enumerate(positional):
        if a.arg == "collector":
            if i >= offset:
                d = defaults[i - offset]
                return isinstance(d, ast.Constant) and d.value is None
            return False
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if a.arg == "collector":
            return isinstance(d, ast.Constant) and d.value is None
    return False


def _has_none_test(fn: ast.AST, roots: Set[str], excluded: Set[int]) -> bool:
    """True when the body tests any collector root against ``None``."""
    for n in ast.walk(fn):
        if id(n) in excluded:
            continue
        if isinstance(n, ast.Compare) and _none_test(n, roots) is not None:
            return True
    return False


def _collector_roots(fn: ast.AST, excluded: Set[int]) -> Set[str]:
    """Dotted expressions denoting the collector inside this unit."""
    roots: Set[str] = set()
    if _has_collector_param(fn):
        roots.add("collector")
    for n in ast.walk(fn):
        if id(n) in excluded:
            continue
        if isinstance(n, ast.Attribute):
            dn = dotted_name(n)
            if dn in ("self._collector", "self.collector"):
                roots.add(dn)
    return roots


def _none_test(test: ast.AST, roots: Set[str]) -> Optional[Tuple[str, bool]]:
    """(root, is_not_none) when ``test`` is ``<root> is [not] None``."""
    if (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], (ast.Is, ast.IsNot))
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
    ):
        dn = dotted_name(test.left)
        if dn in roots:
            return dn, isinstance(test.ops[0], ast.IsNot)
    return None


def _body_guarded(test: ast.AST, roots: Set[str]) -> bool:
    """True when the if-body only runs with the collector present."""
    nt = _none_test(test, roots)
    if nt is not None:
        return nt[1]
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(
            (_none_test(v, roots) or (None, False))[1]
            for v in test.values
        )
    return False


def _implies_present_after(test: ast.AST, roots: Set[str]) -> bool:
    """True when a terminating if-body proves the collector is present
    afterwards (test is ``x is None`` or an or-chain containing it)."""
    nt = _none_test(test, roots)
    if nt is not None:
        return not nt[1]
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        return any(
            _none_test(v, roots) is not None
            and not _none_test(v, roots)[1]
            for v in test.values
        )
    return False


def _terminates(stmts: List[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


class CollectorPurityChecker(Checker):
    code = "RPA007"
    name = "collector-purity"
    description = (
        "obs work must be guarded under `collector is not None` and "
        "guarded blocks must not write engine state "
        "(collector=None is bitwise-uninstrumented)"
    )

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if "collector" not in mod.source:
            return  # no parameter or attribute the rule could root on
        units = []
        for qual, fn in walk_functions(mod.tree):
            units.append((qual, fn))
        with_param = {id(fn) for _, fn in units if _has_collector_param(fn)}
        for qual, fn in units:
            # nested units with their own collector param are analyzed
            # standalone; exclude their subtrees from the enclosing unit
            excluded: Set[int] = set()
            for n in ast.walk(fn):
                if n is not fn and id(n) in with_param:
                    for sub in ast.walk(n):
                        excluded.add(id(sub))
            roots = _collector_roots(fn, excluded)
            if not roots:
                continue
            # The contract covers *optional* collectors only: a required
            # collector argument (no None default, never None-tested —
            # e.g. an obs-layer helper that always receives one) is not
            # subject to the guarded-use rule.
            if not (
                (_has_collector_param(fn) and _collector_param_optional(fn))
                or _has_none_test(fn, roots, excluded)
            ):
                continue
            yield from self._check_unit(mod, qual, fn, roots, excluded)

    # ------------------------------------------------------------------

    def _check_unit(
        self,
        mod: ModuleInfo,
        qual: str,
        fn: ast.AST,
        roots: Set[str],
        excluded: Set[int],
    ) -> Iterator[Finding]:
        aliases = set(roots)
        self._collect_aliases(fn, aliases, excluded)

        guarded: Set[int] = set()
        self._mark(fn.body, aliases, False, guarded, excluded)
        self._mark_expr_guards(fn, aliases, guarded, excluded)

        outside = self._outside_bindings(fn, guarded, aliases, excluded)

        for n in ast.walk(fn):
            if id(n) in excluded or n is fn:
                continue
            if id(n) in guarded:
                yield from self._guarded_rules(
                    mod, qual, n, aliases, outside
                )
            else:
                yield from self._unguarded_rules(mod, qual, n, aliases)

    def _collect_aliases(
        self, fn: ast.AST, aliases: Set[str], excluded: Set[int]
    ) -> None:
        changed = True
        while changed:
            changed = False
            for n in ast.walk(fn):
                if id(n) in excluded:
                    continue
                if isinstance(n, ast.Assign) and self._alias_expr(
                    n.value, aliases
                ):
                    for t in n.targets:
                        if isinstance(t, ast.Name) and t.id not in aliases:
                            aliases.add(t.id)
                            changed = True

    def _alias_expr(self, expr: Optional[ast.AST], aliases: Set[str]) -> bool:
        """True when ``expr`` *produces* a collector-derived object: a
        bare copy of an alias, or a call dispatched *on* an alias
        (``collector.phase(...)``).  Merely passing the collector as an
        argument (``simulate(..., collector=collector)``) does not make
        the result obs-owned — the callee re-guards."""
        if expr is None:
            return False
        if isinstance(expr, ast.Name):
            return expr.id in aliases
        if isinstance(expr, ast.Attribute):
            return dotted_name(expr) in aliases
        if isinstance(expr, ast.Call):
            fn = expr.func
            while isinstance(fn, ast.Attribute):
                if dotted_name(fn) in aliases:
                    return True
                fn = fn.value
            return isinstance(fn, ast.Name) and fn.id in aliases
        if isinstance(expr, ast.IfExp):
            return self._alias_expr(expr.body, aliases) or self._alias_expr(
                expr.orelse, aliases
            )
        return False

    def _rooted(self, expr: Optional[ast.AST], aliases: Set[str]) -> bool:
        if expr is None:
            return False
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and n.id in aliases:
                return True
            if isinstance(n, ast.Attribute) and dotted_name(n) in aliases:
                return True
        return False

    # -- guard propagation -------------------------------------------------

    def _mark(
        self,
        stmts: List[ast.stmt],
        aliases: Set[str],
        guarded: bool,
        out: Set[int],
        excluded: Set[int],
    ) -> None:
        present = guarded
        for stmt in stmts:
            if id(stmt) in excluded:
                continue
            if present:
                for sub in ast.walk(stmt):
                    if id(sub) not in excluded:
                        out.add(id(sub))
                continue
            if isinstance(stmt, ast.If):
                self._mark(
                    stmt.body, aliases,
                    _body_guarded(stmt.test, aliases), out, excluded,
                )
                nt = _none_test(stmt.test, aliases)
                else_guarded = nt is not None and not nt[1]
                self._mark(stmt.orelse, aliases, else_guarded, out, excluded)
                if (
                    _implies_present_after(stmt.test, aliases)
                    and _terminates(stmt.body)
                ):
                    present = True
                continue
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if isinstance(sub, list) and sub and isinstance(
                    sub[0], ast.stmt
                ):
                    self._mark(sub, aliases, False, out, excluded)
            for handler in getattr(stmt, "handlers", []) or []:
                self._mark(handler.body, aliases, False, out, excluded)

    def _mark_expr_guards(
        self,
        fn: ast.AST,
        aliases: Set[str],
        guarded: Set[int],
        excluded: Set[int],
    ) -> None:
        """Expression-level guards: ``x.y if x is not None else z`` and
        short-circuit chains ``x is not None and x.y`` /
        ``x is None or x.y``."""
        for n in ast.walk(fn):
            if id(n) in excluded:
                continue
            if isinstance(n, ast.IfExp):
                if _body_guarded(n.test, aliases):
                    guarded.update(id(s) for s in ast.walk(n.body))
                nt = _none_test(n.test, aliases)
                if nt is not None and not nt[1]:
                    guarded.update(id(s) for s in ast.walk(n.orelse))
            elif isinstance(n, ast.BoolOp):
                seen_guard = False
                for v in n.values:
                    if seen_guard:
                        guarded.update(id(s) for s in ast.walk(v))
                        continue
                    nt = _none_test(v, aliases)
                    if nt is not None and (
                        nt[1] if isinstance(n.op, ast.And) else not nt[1]
                    ):
                        seen_guard = True

    # -- bindings ----------------------------------------------------------

    def _outside_bindings(
        self,
        fn: ast.AST,
        guarded: Set[int],
        aliases: Set[str],
        excluded: Set[int],
    ) -> Set[str]:
        bound: Set[str] = set()
        args = fn.args
        for a in (
            list(args.args) + list(args.posonlyargs) + list(args.kwonlyargs)
        ):
            bound.add(a.arg)
        if args.vararg:
            bound.add(args.vararg.arg)
        if args.kwarg:
            bound.add(args.kwarg.arg)
        for n in ast.walk(fn):
            if id(n) in guarded or id(n) in excluded:
                continue
            targets: List[ast.AST] = []
            if isinstance(n, ast.Assign):
                targets = list(n.targets)
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            elif isinstance(n, (ast.For, ast.AsyncFor)):
                targets = [n.target]
            elif isinstance(n, ast.withitem) and n.optional_vars:
                targets = [n.optional_vars]
            for t in targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        bound.add(sub.id)
        return bound - aliases

    # -- rule bodies -------------------------------------------------------

    def _unguarded_rules(
        self, mod: ModuleInfo, qual: str, n: ast.AST, aliases: Set[str]
    ) -> Iterator[Finding]:
        if isinstance(n, ast.Attribute):
            base = n.value
            base_dn = (
                base.id if isinstance(base, ast.Name) else dotted_name(base)
            )
            full = dotted_name(n)
            if base_dn in aliases and full not in aliases:
                yield self.finding(
                    mod, n,
                    f"unguarded collector use "
                    f"`{full or f'{base_dn}.{n.attr}'}` — wrap in "
                    f"`if {base_dn} is not None:` (collector=None must be "
                    f"bitwise-uninstrumented)",
                    qual,
                )

    def _guarded_rules(
        self,
        mod: ModuleInfo,
        qual: str,
        n: ast.AST,
        aliases: Set[str],
        outside: Set[str],
    ) -> Iterator[Finding]:
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            for t, value in paired_targets(n):
                rhs_obs = self._rooted(value, aliases)
                if isinstance(t, ast.Name):
                    if t.id in outside and (
                        isinstance(n, ast.AugAssign) or not rhs_obs
                    ):
                        yield self.finding(
                            mod, n,
                            f"assignment to `{t.id}` (also bound outside "
                            f"the guard) inside a collector-guarded block "
                            f"— engine state must be identical with "
                            f"collector=None",
                            qual,
                        )
                elif isinstance(t, (ast.Subscript, ast.Attribute)):
                    root = t.value
                    root_dn = (
                        root.id if isinstance(root, ast.Name)
                        else dotted_name(root)
                    )
                    if root_dn not in aliases and not rhs_obs:
                        yield self.finding(
                            mod, n,
                            "store through a non-collector object inside "
                            "a collector-guarded block — engine state "
                            "must be identical with collector=None",
                            qual,
                        )
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr in _MUTATORS and isinstance(
                n.func.value, ast.Name
            ):
                base_dn = n.func.value.id
                if base_dn in outside and base_dn not in aliases:
                    yield self.finding(
                        mod, n,
                        f"mutating call `{base_dn}.{n.func.attr}()` on an "
                        f"engine-state object inside a collector-guarded "
                        f"block",
                        qual,
                    )
