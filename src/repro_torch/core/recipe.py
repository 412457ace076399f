"""QuantRecipe: declarative per-target quantization rules, and the
Hessian-budgeted mixed-precision allocator; port of ``repro/core/recipe.py``.

A recipe is an ordered list of ``Rule(pattern, action)`` entries matched
against the canonical target names the family adapters emit
(``<block_prefix>.<leaf>``, e.g. ``layers.3.attn.wq``). Patterns are shell
globs (``fnmatch``) plus ``group:attn`` / ``group:mlp``. **First match
wins.** Unmatched targets fall back to the adapter-declared default action,
then the recipe's ``default``; in ``strict`` mode an unmatched target
without an adapter default is an error. Adapter-declared exclusions yield
only to exact-name rules.

Actions:
  * ``Quantize(cfg)``      — GPTVQ (or its kmeans ablations) at a
                             per-target ``VQConfig``.
  * ``IntQuant(bits, gs)`` — uniform integer quantization (GPTQ error
                             feedback by default, plain RTN optionally).
  * ``KeepDense(reason)``  — leave the leaf untouched.

On top of rules, ``allocate_budget`` solves Hessian-budgeted mixed
precision: it scores every Quantize-resolved target at each candidate
setting with a diagonal-Hessian-weighted proxy (the O(r*c) closed form by
default, the trimmed-EM refit as ``scorer="refit"``) and greedily upgrades
the most error-reducing targets per bit spent while the model-wide
weighted bpv stays within the budget. It is the reference's greedy line for
line, including its skip of any upgrade that would overshoot the budget
(which makes the allocation non-monotone in the budget).

JSON schema (the reference's)::

    {"name": "mixed-demo", "strict": false,
     "default": {"action": "quantize", "setting": "2.25bpv_2d"},
     "rules": [
       {"pattern": "group:attn", "action": "quantize",
        "setting": "2.25bpv_2d", "overrides": {"em_iters": 25}},
       {"pattern": "group:mlp", "action": "int_quant",
        "bits": 4, "group_size": 128},
       {"pattern": "layers.0.ffn.w_in", "action": "keep_dense",
        "reason": "first-layer sensitivity"}]}
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Any, Union

import torch

from repro_torch.core.bpv import (
    DENSE_BITS,
    PAPER_SETTINGS,
    VQConfig,
    effective_bpv,
    int_quant_bpv,
)


@dataclasses.dataclass(frozen=True)
class Quantize:
    """Vector-quantize with GPTVQ (method="gptvq") or one of its data
    ablations ("kmeans": identity Hessian, no feedback; "kmeans_data":
    diagonal Hessian, no feedback). ``solver`` picks the sweep's inner
    assignment rule (core/solvers.py): "gptq", "babai" or "cd"."""

    cfg: VQConfig = VQConfig()
    method: str = "gptvq"
    solver: str = "gptq"

    @property
    def needs_hessian(self) -> bool:
        return self.method != "kmeans"

    def bpv(self, r: int, c: int) -> float:
        return effective_bpv(self.cfg, r, c)


@dataclasses.dataclass(frozen=True)
class IntQuant:
    """Uniform integer quantization: GPTQ error feedback by default,
    plain round-to-nearest with method="rtn"."""

    bits: int = 4
    group_size: int = 128
    method: str = "gptq"

    @property
    def needs_hessian(self) -> bool:
        return self.method == "gptq"

    def bpv(self, r: int, c: int) -> float:
        return int_quant_bpv(self.bits, self.group_size, c)


@dataclasses.dataclass(frozen=True)
class KeepDense:
    """Leave the leaf dense; counted at DENSE_BITS in the weighted bpv."""

    reason: str = ""

    needs_hessian = False

    def bpv(self, r: int, c: int) -> float:
        return DENSE_BITS


RuleAction = Union[Quantize, IntQuant, KeepDense]


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

    def with_solver(self, solver: str) -> "QuantRecipe":
        """A copy with ``solver`` set on every Quantize action — the
        launcher's ``--solver`` flag applies it globally."""
        from repro_torch.core.solvers import VALID_SOLVERS

        if solver not in VALID_SOLVERS:
            raise RecipeError(f"unknown solver {solver!r}; expected one "
                              f"of {VALID_SOLVERS}")

        def fix(action):
            if not isinstance(action, Quantize):
                return action
            return dataclasses.replace(action, solver=solver)

        return dataclasses.replace(
            self,
            rules=tuple(dataclasses.replace(r, action=fix(r.action))
                        for r in self.rules),
            default=None if self.default is None else fix(self.default))

    @staticmethod
    def uniform(cfg: VQConfig, method: str = "gptvq",
                name: str = "") -> "QuantRecipe":
        return QuantRecipe(rules=(), default=Quantize(cfg, method), name=name)

    @staticmethod
    def from_legacy(method: str, cfg, *, quantize_attn: bool = True,
                    quantize_mlp: bool = True) -> "QuantRecipe":
        """Compile the legacy ``quantize_model(method, cfg, quantize_attn=,
        quantize_mlp=)`` surface into an equivalent recipe."""
        if method in ("rtn", "gptq"):
            cfg = cfg if cfg is not None else {"bits": 4, "group_size": 128}
            action: RuleAction = IntQuant(cfg["bits"], cfg["group_size"],
                                          method=method)
        elif method in ("gptvq", "kmeans", "kmeans_data"):
            action = Quantize(cfg if cfg is not None else VQConfig(), method)
        else:
            raise RecipeError(f"unknown method {method!r}")
        rules = []
        if not quantize_attn:
            rules.append(Rule("group:attn", KeepDense("quantize_attn=False")))
        if not quantize_mlp:
            rules.append(Rule("group:mlp", KeepDense("quantize_mlp=False")))
        return QuantRecipe(rules=tuple(rules), default=action,
                           name=f"legacy:{method}")

    # -- (de)serialization --------------------------------------------------

    def to_json(self) -> dict:
        """The reference's JSON form (also the checkpoint's metadata)."""
        out: dict[str, Any] = {"name": self.name, "strict": self.strict,
                               "rules": [
                                   {"pattern": r.pattern,
                                    **_action_to_json(r.action)}
                                   for r in self.rules]}
        if self.default is not None:
            out["default"] = _action_to_json(self.default)
        return out

    @staticmethod
    def from_json(obj: dict) -> "QuantRecipe":
        rules = tuple(
            Rule(r["pattern"], _action_from_json(r))
            for r in obj.get("rules", ()))
        default = (_action_from_json(obj["default"])
                   if "default" in obj else None)
        strict = bool(obj.get("strict", False))
        if strict and "default" in obj:
            raise RecipeError("strict recipe cannot carry a default action")
        # no implicit default: a JSON recipe that omits "default" covers
        # only what its rules (and adapter defaults) match
        return QuantRecipe(rules=rules, default=default, strict=strict,
                           name=obj.get("name", ""))

    @staticmethod
    def from_file(path: str) -> "QuantRecipe":
        with open(path) as f:
            return QuantRecipe.from_json(json.load(f))


def _vq_cfg_from_json(spec: dict) -> VQConfig:
    base = PAPER_SETTINGS[spec["setting"]] if "setting" in spec else VQConfig()
    overrides = spec.get("overrides", {})
    unknown = set(overrides) - {f.name for f in dataclasses.fields(VQConfig)}
    if unknown:
        raise RecipeError(f"unknown VQConfig override(s): {sorted(unknown)}")
    return dataclasses.replace(base, **overrides)


def _action_from_json(spec: dict) -> RuleAction:
    kind = spec.get("action", "quantize")
    if kind == "quantize":
        return Quantize(_vq_cfg_from_json(spec),
                        method=spec.get("method", "gptvq"),
                        solver=spec.get("solver", "gptq"))
    if kind == "int_quant":
        return IntQuant(int(spec.get("bits", 4)),
                        int(spec.get("group_size", 128)),
                        method=spec.get("method", "gptq"))
    if kind == "keep_dense":
        return KeepDense(spec.get("reason", ""))
    raise RecipeError(f"unknown action {kind!r}")


def _action_to_json(action: RuleAction) -> dict:
    if isinstance(action, Quantize):
        out: dict[str, Any] = {"action": "quantize"}
        if action.method != "gptvq":
            out["method"] = action.method
        if action.solver != "gptq":
            out["solver"] = action.solver
        # the matching paper setting when one exists, else the raw fields
        for name, cfg in PAPER_SETTINGS.items():
            if action.cfg == cfg:
                out["setting"] = name
                return out
        out["overrides"] = {
            f.name: getattr(action.cfg, f.name)
            for f in dataclasses.fields(VQConfig)
            if getattr(action.cfg, f.name) != f.default}
        return out
    if isinstance(action, IntQuant):
        out = {"action": "int_quant", "bits": action.bits,
               "group_size": action.group_size}
        if action.method != "gptq":
            out["method"] = action.method
        return out
    return {"action": "keep_dense", "reason": action.reason}


# named presets: every PAPER_SETTINGS point as a single-rule (uniform)
# recipe, plus the mixed demo
PRESET_RECIPES: dict[str, QuantRecipe] = {
    name: QuantRecipe.uniform(cfg, name=name)
    for name, cfg in PAPER_SETTINGS.items()
}
PRESET_RECIPES["mixed_demo"] = QuantRecipe(
    rules=(
        Rule("group:attn", Quantize(PAPER_SETTINGS["2.25bpv_2d"])),
        Rule("group:mlp", Quantize(PAPER_SETTINGS["4.125bpv_1d"])),
    ),
    default=Quantize(PAPER_SETTINGS["2.25bpv_2d"]),
    name="mixed_demo",
)


def get_recipe(spec: str) -> QuantRecipe:
    """Resolve a CLI recipe argument: a preset name or a JSON file path."""
    if spec in PRESET_RECIPES:
        return PRESET_RECIPES[spec]
    if spec.endswith(".json"):
        return QuantRecipe.from_file(spec)
    raise RecipeError(
        f"unknown recipe {spec!r}: not a preset "
        f"({sorted(PRESET_RECIPES)}) and not a .json path")


# ---------------------------------------------------------------------------
# Hessian-budgeted mixed-precision allocation
# ---------------------------------------------------------------------------

# candidate settings the allocator may assign, cheapest-first by nominal
# bpv; targets whose column count is not divisible by a setting's d skip it
BUDGET_CANDIDATES = tuple(sorted(
    PAPER_SETTINGS, key=lambda n: PAPER_SETTINGS[n].bits_per_value))


@dataclasses.dataclass
class BudgetEntry:
    """One Quantize-resolved target entering the allocation."""

    name: str
    W: torch.Tensor                # (r, c) float32, GPTVQ orientation
    diag_h: torch.Tensor | None    # (c,) diagonal Hessian (None -> identity)
    base_cfg: VQConfig             # non-(d,bits,gs,cb) fields carry over
    numel: int                     # weights this choice prices
    replicas: int = 1              # matrices sharing this choice


def _proxy_error(W: torch.Tensor, diag_h, cfg: VQConfig,
                 max_rows: int = 32) -> float:
    """Refit proxy for the reconstruction error of ``cfg`` on W: a short
    diagonal-Hessian-weighted EM fit (no GPTQ error feedback) on a row
    subsample, scaled back to the full matrix. The validation oracle for
    :func:`closed_form_proxy_error` (``scorer="refit"``); on CUDA it runs
    the ``vq_em`` and ``vq_group_sweep`` kernels."""
    from repro_torch.core.gptvq import gptvq_quantize_matrix, layer_error

    r, c = W.shape
    step = max(1, r // max_rows)
    Ws = W[::step][:max_rows]
    if diag_h is None:
        diag_h = torch.ones((c,), dtype=torch.float32, device=W.device)
    d = torch.clamp(diag_h.to(torch.float32), min=1e-10)
    Ud = torch.diag(1.0 / torch.sqrt(d))  # diagonal H -> Hinv = U^T U
    cfg = dataclasses.replace(cfg, em_iters=min(cfg.em_iters, 6),
                              codebook_update_iters=0, exact_span_solve=False)
    res = gptvq_quantize_matrix(Ws, Ud, cfg)
    err = float(layer_error(Ws, res.arrays.Q, torch.diag(d)))
    return err * (r / Ws.shape[0])


# Gersho's conjectured normalized second moments of the optimal lattice
# quantizer per dimension (d=1 interval, d=2 hexagonal, d=3 BCC, d=4 D4)
_GERSHO_G = {1: 1.0 / 12.0, 2: 5.0 / (36.0 * 3.0 ** 0.5),
             3: 0.0785, 4: 0.0766}


def _cf_weighted_variance(W, h, *, n_bands, rg, n_cg, spans_pg, d):
    """Hessian-weighted total variance per (band, column group), summed."""
    X = W.to(torch.float32).reshape(n_bands, rg, n_cg, spans_pg, d)
    Hw = h.reshape(n_cg, spans_pg, d)
    # weighted mean per (band, group, coordinate) over the n_vec vectors
    wsum = rg * torch.sum(Hw, dim=1)  # (n_cg, d)
    mu = (torch.einsum("bigjp,gjp->bgp", X, Hw)
          / torch.clamp(wsum[None], min=1e-20))
    diff = X - mu[:, None, :, None, :]
    return torch.einsum("bigjp,gjp->", diff * diff, Hw)


def closed_form_proxy_error(W: torch.Tensor, diag_h, cfg: VQConfig) -> float:
    """Rate-distortion closed form for the reconstruction error of
    ``cfg`` on W — no EM refit, no sweep: O(r*c) per candidate.

    High-rate VQ theory prices a k-centroid codebook on n d-vectors at
    D ≈ G_d * 2^(-2*bits_per_dim) * V, G_d the Gersho lattice constant and
    V the Hessian-weighted total variance of the vectors around their
    weighted mean, per (row band, column group), times the finite-k
    coverage factor ``max(1 - k/n_vec, 0)``.
    """
    from repro_torch.core.gptvq import plan_groups

    r, c = W.shape
    cg, rg = plan_groups(r, c, cfg)
    d, k = cfg.d, cfg.k
    n_cg, n_bands, spans_pg = c // cg, r // rg, cg // d
    n_vec = rg * spans_pg
    coverage = max(1.0 - k / n_vec, 0.0)
    if coverage == 0.0:
        return 0.0
    if diag_h is None:
        h = torch.ones((c,), dtype=torch.float32, device=W.device)
    else:
        h = torch.clamp(diag_h.to(torch.float32), min=1e-10)
    V = _cf_weighted_variance(W, h, n_bands=n_bands, rg=rg, n_cg=n_cg,
                              spans_pg=spans_pg, d=d)
    g_d = _GERSHO_G.get(d, _GERSHO_G[4])
    return float(g_d * 2.0 ** (-2.0 * cfg.bits_per_dim) * coverage * V)


PROXY_SCORERS = {
    "closed_form": lambda W, diag_h, cfg: closed_form_proxy_error(
        W, diag_h, cfg),
    "refit": lambda W, diag_h, cfg: _proxy_error(W, diag_h, cfg),
}


def allocate_budget(
    entries: list[BudgetEntry],
    budget_bpv: float,
    *,
    fixed_bits: float = 0.0,      # Σ numel*bpv of non-Quantize targets
    fixed_numel: int = 0,
    candidates: tuple[str, ...] = BUDGET_CANDIDATES,
    scorer: str = "closed_form",
    progress=None,
) -> dict[str, tuple[str, VQConfig]]:
    """Greedy discrete allocation: start every target at its cheapest
    feasible setting, then repeatedly apply the upgrade with the best
    proxy-error reduction per extra bit while the model-wide weighted
    bpv (including ``fixed_*`` contributions from int/dense targets)
    stays <= ``budget_bpv``. Returns {target name: (setting, VQConfig)}.
    """
    if not entries:
        return {}
    try:
        score = PROXY_SCORERS[scorer]
    except KeyError:
        raise RecipeError(f"unknown budget scorer {scorer!r}; expected "
                          f"one of {sorted(PROXY_SCORERS)}")
    table: dict[str, list[tuple[str, VQConfig, float, float]]] = {}
    for e in entries:
        r, c = e.W.shape
        rows = []
        for setting in candidates:
            base = PAPER_SETTINGS[setting]
            if c % base.d != 0:
                continue
            cfg = dataclasses.replace(
                e.base_cfg, d=base.d, bits_per_dim=base.bits_per_dim,
                group_size=base.group_size, codebook_bits=base.codebook_bits)
            bpv = effective_bpv(cfg, r, c)
            err = score(e.W, e.diag_h, cfg) * e.replicas
            rows.append((setting, cfg, bpv, err))
        if not rows:
            raise RecipeError(
                f"no candidate setting fits target {e.name!r} "
                f"(c={c} not divisible by any candidate d)")
        table[e.name] = rows
        if progress:
            progress(f"budget proxy: {e.name} ({len(rows)} candidates)")

    numel = {e.name: e.numel for e in entries}
    total_numel = fixed_numel + sum(numel.values())
    # start at the cheapest effective bpv (ties: lower proxy error)
    choice: dict[str, int] = {}
    for nm, rows in table.items():
        choice[nm] = min(range(len(rows)), key=lambda i: (rows[i][2],
                                                          rows[i][3]))
    bits = fixed_bits + sum(
        numel[nm] * table[nm][choice[nm]][2] for nm in table)
    if bits / total_numel > budget_bpv + 1e-9:
        raise RecipeError(
            f"budget {budget_bpv} bpv infeasible: cheapest allocation "
            f"already needs {bits / total_numel:.3f} bpv")

    while True:
        best = None  # (efficiency, name, cand_index, delta_bits)
        for nm, rows in table.items():
            cur = rows[choice[nm]]
            for i, cand in enumerate(rows):
                dbits = (cand[2] - cur[2]) * numel[nm]
                derr = cur[3] - cand[3]
                if dbits <= 0 or derr <= 0:
                    continue
                if (bits + dbits) / total_numel > budget_bpv + 1e-9:
                    continue
                eff = derr / dbits
                if best is None or eff > best[0]:
                    best = (eff, nm, i, dbits)
        if best is None:
            break
        _, nm, i, dbits = best
        choice[nm] = i
        bits += dbits

    return {nm: (table[nm][choice[nm]][0], table[nm][choice[nm]][1])
            for nm in table}
