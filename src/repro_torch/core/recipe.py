"""QuantRecipe: declarative per-target quantization rules (the rule half of
``repro/core/recipe.py``).

A recipe is an ordered list of ``Rule(pattern, action)`` entries matched
against the canonical target names the family adapters emit
(``<block_prefix>.<leaf>``, e.g. ``layers.3.attn.wq``). Patterns are shell
globs (``fnmatch``) plus ``group:attn`` / ``group:mlp``. **First match
wins.** Unmatched targets fall back to the adapter-declared default action,
then the recipe's ``default``; in ``strict`` mode an unmatched target
without an adapter default is an error. Adapter-declared exclusions yield
only to exact-name rules.

Actions ported here: ``Quantize(cfg)`` and ``KeepDense(reason)``.
``IntQuant``, JSON recipes and the budget allocator are not ported yet
(ROADMAP.md queue 1, "Budgets and solvers").
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Union

from repro_torch.core.bpv import DENSE_BITS, PAPER_SETTINGS, VQConfig, effective_bpv
from repro_torch.pending import not_ported

_PENDING = "not ported yet (ROADMAP.md queue 1, 'Budgets and solvers')"


@dataclasses.dataclass(frozen=True)
class Quantize:
    """Vector-quantize with GPTVQ at a per-target ``VQConfig``. Only
    method="gptvq" with solver="gptq" is ported."""

    cfg: VQConfig = VQConfig()
    method: str = "gptvq"
    solver: str = "gptq"

    @property
    def needs_hessian(self) -> bool:
        return self.method != "kmeans"

    def bpv(self, r: int, c: int) -> float:
        return effective_bpv(self.cfg, r, c)


@dataclasses.dataclass(frozen=True)
class KeepDense:
    """Leave the leaf dense; counted at DENSE_BITS in the weighted bpv."""

    reason: str = ""

    needs_hessian = False

    def bpv(self, r: int, c: int) -> float:
        return DENSE_BITS


RuleAction = Union[Quantize, KeepDense]


@dataclasses.dataclass(frozen=True)
class Rule:
    pattern: str
    action: RuleAction

    def matches(self, name: str, group: str) -> bool:
        if self.pattern.startswith("group:"):
            return group == self.pattern[len("group:"):]
        return fnmatch.fnmatchcase(name, self.pattern)

    @property
    def explicit(self) -> bool:
        """True for an exact-name rule (no glob metacharacters, not a
        group: pattern) — the only kind that can override an
        adapter-declared keep_dense default."""
        return (not self.pattern.startswith("group:")
                and not any(ch in self.pattern for ch in "*?["))


@dataclasses.dataclass(frozen=True)
class TargetInfo:
    """What the resolver needs to know about one quantizable leaf."""

    name: str                 # canonical: "<block_prefix>.<spec.name>"
    group: str                # WeightSpec.group ("attn" / "mlp")
    r: int                    # out_features (GPTVQ row dim)
    c: int                    # in_features
    numel: int                # total weights
    default_action: RuleAction | None = None  # adapter-declared fallback


@dataclasses.dataclass(frozen=True)
class Resolved:
    """One target's resolved treatment plus its provenance."""

    action: RuleAction
    rule: str                 # "rule[i]:<pattern>" | "default" | "adapter:<reason>"

    @property
    def needs_hessian(self) -> bool:
        return self.action.needs_hessian


class RecipeError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """Ordered first-match-wins rules + default, over canonical names."""

    rules: tuple[Rule, ...] = ()
    default: RuleAction | None = Quantize()
    strict: bool = False
    name: str = ""

    def __post_init__(self):
        if self.strict and self.default is not None:
            raise RecipeError("strict recipe cannot carry a default action")

    def resolve(self, targets: list[TargetInfo]) -> dict[str, Resolved]:
        """Map every target to its action."""
        plan: dict[str, Resolved] = {}
        unmatched: list[str] = []
        for t in targets:
            if t.name in plan:
                raise RecipeError(f"duplicate canonical target {t.name!r}")
            hit = None
            for i, rule in enumerate(self.rules):
                if not rule.matches(t.name, t.group):
                    continue
                if t.default_action is not None and not rule.explicit:
                    continue  # adapter exclusions need a by-name rule
                hit = Resolved(rule.action, f"rule[{i}]:{rule.pattern}")
                break
            if hit is None and t.default_action is not None:
                reason = getattr(t.default_action, "reason", "")
                hit = Resolved(t.default_action, f"adapter:{reason}")
            if hit is None:
                if self.strict or self.default is None:
                    unmatched.append(t.name)
                    continue
                hit = Resolved(self.default, "default")
            plan[t.name] = hit
        if unmatched:
            why = "strict recipe" if self.strict else "recipe has no default"
            raise RecipeError(
                f"{why}: no rule matches target(s) "
                + ", ".join(repr(n) for n in unmatched[:8])
                + ("..." if len(unmatched) > 8 else ""))
        return plan

    def with_quantize_overrides(self, **kw) -> "QuantRecipe":
        """A copy with VQConfig fields overridden on every Quantize action
        (rules and default) — launchers apply global speed knobs with it."""
        def fix(action):
            if not isinstance(action, Quantize):
                return action
            return dataclasses.replace(
                action, cfg=dataclasses.replace(action.cfg, **kw))

        return dataclasses.replace(
            self,
            rules=tuple(dataclasses.replace(r, action=fix(r.action))
                        for r in self.rules),
            default=None if self.default is None else fix(self.default))

    @staticmethod
    def uniform(cfg: VQConfig, method: str = "gptvq",
                name: str = "") -> "QuantRecipe":
        return QuantRecipe(rules=(), default=Quantize(cfg, method), name=name)


PRESET_RECIPES: dict[str, QuantRecipe] = {
    name: QuantRecipe.uniform(cfg, name=name)
    for name, cfg in PAPER_SETTINGS.items()
}


def get_recipe(spec: str) -> QuantRecipe:
    """Resolve a CLI recipe argument: a PAPER_SETTINGS preset name."""
    if spec in PRESET_RECIPES:
        return PRESET_RECIPES[spec]
    if spec.endswith(".json"):
        raise NotImplementedError(f"JSON recipes are {_PENDING}")
    raise RecipeError(f"unknown recipe {spec!r}: not a preset "
                      f"({sorted(PRESET_RECIPES)})")


IntQuant = not_ported("recipe.IntQuant", "Budgets and solvers")
allocate_budget = not_ported("recipe.allocate_budget", "Budgets and solvers")
closed_form_proxy_error = not_ported("recipe.closed_form_proxy_error",
                                     "Budgets and solvers")
