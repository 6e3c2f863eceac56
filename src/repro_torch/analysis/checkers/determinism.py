"""RPA001–RPA003: engine-path determinism.

The port's PON/FL co-simulation engine (``repro_torch.net``,
``repro_torch.kernels``, ``repro_torch.faults``) is bitwise-reproducible
because every random draw is a counter-based threefry stream keyed on
``(seed, phase, round, ...)`` and nothing reads ambient host state.
These rules keep it that way:

* **RPA001** — host RNG: in the engine packages, stdlib ``random.*``,
  any ``np.random.*`` call outside an explicitly *seeded*
  ``default_rng``/``Generator`` construction, and ``np.random.seed``
  (global-state mutation). Across the whole port, torch's global
  generator: a sampling call (``torch.rand``/``randn``/``randint``/
  ``randperm``/``normal``/``bernoulli``/``multinomial``/``poisson``,
  their ``_like`` forms) or an in-place sampler (``.uniform_``,
  ``.normal_``, ``.random_``, ``.exponential_``, ``.bernoulli_``,
  ``.geometric_``, ``.cauchy_``, ``.log_normal_``) without
  ``generator=``, and any seeding or state write of the global
  generators (``torch.manual_seed``, ``torch.cuda.manual_seed[_all]``,
  ``torch.seed``, ``set_rng_state``, …). The port's rule is explicit
  ``torch.Generator`` objects, made from the run's seed.
* **RPA002** — wall-clock reads (``time.time``, ``datetime.now``, …):
  simulated time is the only clock the engine may consult.
* **RPA003** — unordered iteration feeding numeric state: iterating a
  ``set``/``frozenset`` (hash order), unsorted ``os.listdir``/``glob``
  results, or ``vars()``-style namespace dicts.  Plain dict iteration
  is *not* flagged — insertion order is deterministic in py3.7+ and the
  engine relies on it.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import (
    Checker,
    Finding,
    ModuleInfo,
    dotted_name,
    resolve_call_target,
)

ENGINE_SCOPE = ("net", "kernels", "faults")

_SEEDED_CTORS = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox"}

_TORCH_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
}

_INPLACE_SAMPLERS = {
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
    "geometric_", "cauchy_", "log_normal_",
}

_GLOBAL_SEEDERS = {
    "torch.manual_seed", "torch.seed", "torch.set_rng_state",
    "torch.random.manual_seed", "torch.random.seed",
    "torch.random.set_rng_state",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all", "torch.cuda.set_rng_state",
    "torch.cuda.set_rng_state_all",
}

#: the last names of every call RPA001's torch half looks at
_TORCH_RNG_LEAVES = (
    _TORCH_SAMPLERS | _INPLACE_SAMPLERS
    | {name.rsplit(".", 1)[-1] for name in _GLOBAL_SEEDERS}
)

_CLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.clock_gettime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

_LISTING_CALLS = {"os.listdir", "os.scandir", "glob.glob", "glob.iglob"}


def _symbol(mod: ModuleInfo, it: ast.AST, node: ast.AST) -> str:
    """The enclosing symbol of an iterable ``it`` of ``node``."""
    return mod.symbols.get(it, mod.symbols.get(node, "<module>"))


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = dotted_name(node.func)
        return fn in ("set", "frozenset")
    return False


class HostRngChecker(Checker):
    code = "RPA001"
    name = "determinism-host-rng"
    description = (
        "engine paths must draw randomness from counter-based streams, "
        "never host RNG (stdlib random, unseeded np.random); the port "
        "never draws from or seeds torch's global generator"
    )

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.in_port():
            return
        engine = mod.in_package(*ENGINE_SCOPE)
        aliases = mod.aliases
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            yield from self._torch_rng(mod, node, aliases)
            if not engine:
                continue
            target = resolve_call_target(node, aliases)
            if target is None:
                continue
            if target.startswith("random."):
                yield self.finding(
                    mod, node,
                    f"stdlib host RNG call `{target}` — engine randomness "
                    f"must come from keyed threefry streams "
                    f"(kernels.traffic / faults.streams)",
                    mod.symbols.get(node, "<module>"),
                )
            elif target.startswith(("numpy.random.", "np.random.")):
                leaf = target.rsplit(".", 1)[1]
                if leaf == "seed":
                    yield self.finding(
                        mod, node,
                        "`np.random.seed` mutates global RNG state — "
                        "engine paths must not touch the legacy global "
                        "generator",
                        mod.symbols.get(node, "<module>"),
                    )
                elif leaf not in _SEEDED_CTORS:
                    yield self.finding(
                        mod, node,
                        f"legacy global-state RNG call `np.random.{leaf}` "
                        f"— use a seeded np.random.default_rng or a "
                        f"counter-based stream",
                        mod.symbols.get(node, "<module>"),
                    )
                elif not node.args and not node.keywords:
                    yield self.finding(
                        mod, node,
                        f"`np.random.{leaf}()` without a seed draws OS "
                        f"entropy — pass an explicit seed",
                        mod.symbols.get(node, "<module>"),
                    )


    def _torch_rng(
        self, mod: ModuleInfo, node: ast.Call, aliases
    ) -> Iterator[Finding]:
        func = node.func
        if isinstance(func, ast.Attribute):
            leaf = func.attr
        elif isinstance(func, ast.Name):
            leaf = aliases.get(func.id, func.id).rsplit(".", 1)[-1]
        else:
            return
        if leaf not in _TORCH_RNG_LEAVES:
            return
        target = resolve_call_target(node, aliases) or ""
        if target in _GLOBAL_SEEDERS:
            yield self.finding(
                mod, node,
                f"`{target}` seeds or overwrites torch's global generator "
                f"— draw from an explicit torch.Generator made from the "
                f"run's seed",
                mod.symbols.get(node, "<module>"),
            )
            return
        # a splatted **kwargs may carry the generator
        if any(kw.arg in ("generator", None) for kw in node.keywords):
            return
        head, _, leaf = target.rpartition(".")
        if head == "torch" and leaf in _TORCH_SAMPLERS:
            yield self.finding(
                mod, node,
                f"`{target}` without `generator=` draws from torch's "
                f"global generator — pass an explicit torch.Generator",
                mod.symbols.get(node, "<module>"),
            )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _INPLACE_SAMPLERS
        ):
            yield self.finding(
                mod, node,
                f"in-place sampler `.{node.func.attr}()` without "
                f"`generator=` draws from torch's global generator — "
                f"pass an explicit torch.Generator",
                mod.symbols.get(node, "<module>"),
            )


class WallClockChecker(Checker):
    code = "RPA002"
    name = "determinism-wall-clock"
    description = (
        "engine paths must not read the wall clock; simulated time is "
        "the only clock"
    )

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.in_package(*ENGINE_SCOPE):
            return
        aliases = mod.aliases
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            target = resolve_call_target(node, aliases)
            if target in _CLOCK_CALLS:
                yield self.finding(
                    mod, node,
                    f"wall-clock read `{target}()` inside an engine path — "
                    f"simulation results must not depend on host time",
                    mod.symbols.get(node, "<module>"),
                )


class UnorderedIterChecker(Checker):
    code = "RPA003"
    name = "determinism-unordered-iteration"
    description = (
        "engine paths must not iterate hash-ordered sets or unsorted "
        "directory listings into numeric state"
    )

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.in_package(*ENGINE_SCOPE):
            return
        aliases = mod.aliases
        sorted_args = set()
        for node in mod.nodes:
            if isinstance(node, ast.Call):
                fn = dotted_name(node.func)
                if fn in ("sorted", "min", "max", "len", "any", "all"):
                    for a in node.args:
                        sorted_args.add(id(a))
        for node in mod.nodes:
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters.extend(g.iter for g in node.generators)
            elif isinstance(node, ast.Call):
                fn = dotted_name(node.func)
                if fn in ("sum", "list", "tuple", "enumerate"):
                    iters.extend(node.args[:1])
            for it in iters:
                if id(it) in sorted_args:
                    continue
                if _is_set_expr(it):
                    yield self.finding(
                        mod, it,
                        "iteration over a set is hash-ordered — sort it "
                        "(or keep a list/array) before it feeds engine "
                        "state",
                        _symbol(mod, it, node),
                    )
                elif isinstance(it, ast.Call):
                    target = resolve_call_target(it, aliases)
                    if target in _LISTING_CALLS:
                        yield self.finding(
                            mod, it,
                            f"`{target}` order is filesystem-dependent — "
                            f"wrap in sorted()",
                            _symbol(mod, it, node),
                        )
                    elif (
                        isinstance(it.func, ast.Attribute)
                        and it.func.attr in ("keys", "values", "items")
                        and isinstance(it.func.value, ast.Call)
                        and dotted_name(it.func.value.func)
                        in ("vars", "globals", "locals")
                    ):
                        yield self.finding(
                            mod, it,
                            "iterating a namespace dict "
                            "(vars/globals/locals) feeds reflection order "
                            "into engine state",
                            _symbol(mod, it, node),
                        )
