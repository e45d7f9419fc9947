"""Declarative alert/SLO rules over the MetricsRegistry.

An :class:`AlertRule` names a metric (exact name or an ``fnmatch`` glob —
``health.chip*.state`` spans a whole fleet), the field to read off its
aggregate (gauge ``value``/``high_water``, counter ``value``, histogram
``count``/``mean``/``min``/``max``/``p50``/``p90``/``p99``), a comparison
against a threshold, an aggregation across glob matches (``max``/``min``/
``sum``) and a debounce (``for_ticks`` consecutive breaching evaluations
before firing).

:class:`AlertEngine` evaluates its rules against a
:class:`~repro_torch.obs.recorder.Recorder`'s registry — the serving engines
call :meth:`AlertEngine.evaluate` at probe cadence — and records state
changes back INTO the recorder: an ``alert`` instant per fire/resolve on
a per-rule track under the ``alerts`` proc (its own Perfetto swimlane in
the Chrome-trace export), plus ``alerts.fired``/``alerts.resolved``
counters and an ``alerts.firing`` gauge; a saved JSONL log keeps those
instants.

Missing metrics make a rule *inactive* (no data is not a breach), so one
default rule set serves both single-chip and fleet runs.

Host-side only. The port's copy of the reference's ``obs/alerts.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Optional, Sequence

from repro_torch.obs.metrics import Counter, Gauge, Histogram
from repro_torch.obs.recorder import NULL_RECORDER, Recorder

__all__ = ["AlertRule", "AlertEngine", "default_slo_rules", "detection_rules"]

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}
_AGGS = {"max": max, "min": min, "sum": sum}
_FIELDS = {
    "counter": ("value",),
    "gauge": ("value", "high_water"),
    "histogram": ("count", "mean", "min", "max", "p50", "p90", "p99"),
}
_PCT = {"p50": 50.0, "p90": 90.0, "p99": 99.0}


def _metric_field(m, field: str) -> Optional[float]:
    """Read one field off a LIVE metric object, computing only what the
    rule asks for (``as_dict`` would serialize three percentiles per
    histogram per tick). Returns None for a field the kind lacks."""
    if isinstance(m, Counter):
        return float(m.value) if field == "value" else None
    if isinstance(m, Gauge):
        if field in ("value", "high_water"):
            return float(getattr(m, field))
        return None
    if isinstance(m, Histogram):
        if field not in _FIELDS["histogram"] or not m.count:
            return None
        if field == "count":
            return float(m.count)
        if field in _PCT:
            return float(m.percentile(_PCT[field]))
        return float(getattr(m, field))
    return None


@dataclass(frozen=True)
class AlertRule:
    """One declarative threshold rule; see module docstring for schema."""

    name: str
    metric: str  # exact metric name or fnmatch glob
    op: str  # ">" ">=" "<" "<="
    threshold: float
    field: str = "value"
    agg: str = "max"  # across glob matches
    for_ticks: int = 1  # consecutive breaching evaluations before firing
    severity: str = "warn"  # "warn" | "page"

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")
        if self.agg not in _AGGS:
            raise ValueError(f"rule {self.name!r}: unknown agg {self.agg!r}")
        if self.for_ticks < 1:
            raise ValueError(f"rule {self.name!r}: for_ticks must be >= 1")
        if not any(self.field in fields for fields in _FIELDS.values()):
            raise ValueError(f"rule {self.name!r}: unknown field {self.field!r}")
        if self.severity not in ("warn", "page"):
            raise ValueError(
                f"rule {self.name!r}: severity must be 'warn' or 'page'"
            )

    def as_dict(self) -> dict:
        return dict(name=self.name, metric=self.metric, field=self.field,
                    op=self.op, threshold=self.threshold, agg=self.agg,
                    for_ticks=self.for_ticks, severity=self.severity)


def default_slo_rules(*, ttft_p99_s: float = 5.0,
                      min_health_score: float = 0.5) -> tuple[AlertRule, ...]:
    """The serving SLO set: tail latency + the detection layer's outputs."""
    return (
        AlertRule("slo.ttft_p99", "serve.ttft_wall_s", ">", ttft_p99_s,
                  field="p99"),
        AlertRule("health.chip_suspect", "health.chip*.state", ">=", 1.0,
                  agg="max", severity="page"),
        AlertRule("health.low_score", "health.chip*.score", "<",
                  min_health_score, agg="min"),
        AlertRule("detect.new_faults", "health.detections", ">", 0.0,
                  agg="max", severity="page"),
    )


def detection_rules() -> tuple[AlertRule, ...]:
    """Detection-only subset: rules that can ONLY fire on real probe/health
    evidence — what the healthy-fleet zero-false-positive gate attaches."""
    return tuple(r for r in default_slo_rules()
                 if r.name.startswith(("health.", "detect.")))


class AlertEngine:
    """Evaluate rules against a recorder's metrics; record fire/resolve."""

    def __init__(self, recorder: Optional[Recorder],
                 rules: Sequence[AlertRule], *, proc: str = "alerts"):
        self.rec = recorder if recorder is not None else NULL_RECORDER
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.rules = tuple(rules)
        self.proc = proc
        self._streak = {r.name: 0 for r in self.rules}
        self._firing: dict[str, float] = {}  # rule -> breaching value at fire
        self._ever_fired: set[str] = set()  # rules that fired at ANY point
        self.fired_total = 0

    def __bool__(self) -> bool:
        return bool(self.rules)

    def _rule_value(self, rule: AlertRule, metrics) -> Optional[float]:
        vals = []
        for name, m in metrics:
            if name != rule.metric and not fnmatchcase(name, rule.metric):
                continue
            v = _metric_field(m, rule.field)
            if v is not None and v == v:  # skip missing/NaN
                vals.append(v)
        if not vals:
            return None
        return float(_AGGS[rule.agg](vals))

    def evaluate(self, *, clock: Optional[int] = None) -> list[str]:
        """One evaluation tick over every rule. Returns the names of rules
        that NEWLY fired this tick (debounce satisfied)."""
        metrics = list(self.rec.metrics.items())
        newly = []
        for rule in self.rules:
            v = self._rule_value(rule, metrics)
            breach = v is not None and _OPS[rule.op](v, rule.threshold)
            self._streak[rule.name] = self._streak[rule.name] + 1 if breach else 0
            if breach and rule.name not in self._firing and (
                self._streak[rule.name] >= rule.for_ticks
            ):
                self._firing[rule.name] = v  # type: ignore[assignment]
                self._ever_fired.add(rule.name)
                self.fired_total += 1
                newly.append(rule.name)
                if self.rec:
                    self.rec.count("alerts.fired")
                    self.rec.instant(
                        "alert", proc=self.proc, track=rule.name,
                        args=dict(state="firing", value=v, clock=clock,
                                  **rule.as_dict()),
                    )
            elif not breach and rule.name in self._firing:
                del self._firing[rule.name]
                if self.rec:
                    self.rec.count("alerts.resolved")
                    self.rec.instant(
                        "alert", proc=self.proc, track=rule.name,
                        args=dict(state="resolved", value=v, clock=clock,
                                  **rule.as_dict()),
                    )
        if self.rec:
            self.rec.gauge_set("alerts.firing", len(self._firing))
        return newly

    def firing(self) -> list[str]:
        return sorted(self._firing)

    def summary(self) -> dict:
        return dict(
            rules=[r.as_dict() for r in self.rules],
            firing=self.firing(),
            fired=sorted(self._ever_fired),
            fired_total=self.fired_total,
        )
