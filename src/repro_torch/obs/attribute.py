"""SLO blame attribution (port of ``repro.obs.attribute``): walk
violations back to the decision at fault.

A violated minute is an *outcome*; the decision that caused it happened
earlier — capacity ordered at the responsible head only becomes ready
``startup_sec`` later. `attribute` walks each violated minute of a
single-lane `ControlTrace` back through that cold-start window to the
last decision whose scale-up could still have landed in time, then
classifies the minute down a cascade of mutually-exclusive causes:

* ``capacity_capped`` — the controller asked for more than
  ``max_replicas``; no decision could have satisfied demand.
* ``cooldown_suppressed`` — a scale-down executed inside the cold-start
  window dropped capacity below what the minute needed.
* ``limiter_clamped`` — the decision wanted enough but the executed
  target was clamped below it (fires only where an external limiter sits
  between desired and target; the simulator's `apply_decision` never
  lowers a scale-up).
* ``confidence_downscale`` — the forecast alone implied enough capacity,
  but the decision came out below need (Algorithm 1's confidence term
  scaled the forecast down past the demand line).
* ``under_forecast`` — everything else: the forecast (or reactive
  signal) under-called demand, including reacting too late for the
  startup pipeline to matter.

Every violated minute lands in exactly one bucket, so the per-cause
violation counts sum to the lane's violation total by construction.

Host-side NumPy, the reference's code unchanged: it takes the numpy
trace (``obs.trace.to_numpy``) of either package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.archetypes import ARCHETYPE_NAMES
from repro_torch.obs.trace import ControlTrace

__all__ = ["CAUSES", "Blame", "need_replicas", "attribute",
           "blame_table", "archetype_counts", "archetype_table",
           "timeline"]

CAUSES = ("capacity_capped", "cooldown_suppressed", "limiter_clamped",
          "confidence_downscale", "under_forecast")


class Blame(NamedTuple):
    """Per-minute verdicts plus the per-cause violation totals."""
    cause: np.ndarray        # [M] int8 index into CAUSES, -1 = no violation
    responsible: np.ndarray  # [M] int64 flat decision index (-1 likewise)
    violated: np.ndarray     # [M] violated requests per minute
    need: np.ndarray         # [M] replicas the minute needed
    counts: dict             # cause name -> violated-request total
    total: float             # sum of counts == sum of violated


def need_replicas(rate_per_min, cfg) -> np.ndarray:
    """Replicas needed to serve `rate_per_min` within the SLO.

    Inverts the fluid M/D/1-style congestion model the plant runs:
    response ~= service / (1 - u) <= slo gives the admissible
    utilization u_slo = 1 - service/slo, so a replica absorbs
    rps_per_replica * u_slo req/s before the queue pushes past the SLO.
    """
    u_slo = max(1.0 - cfg.service_sec / cfg.slo_sec, 0.05)
    rps = np.maximum(np.asarray(rate_per_min, np.float64), 0.0) / 60.0
    return np.ceil(rps / (cfg.rps_per_replica * u_slo))


def attribute(ct: ControlTrace, cfg) -> Blame:
    """Blame every violated minute of ONE lane ([M, H] decisions)."""
    d, mt = ct.decisions, ct.minutes
    M = np.asarray(d.minute).shape[0]
    flat = {f: np.asarray(getattr(d, f), np.float64).reshape(-1)
            for f in d._fields}
    abs_sec = flat["minute"] * 60.0 + flat["sec"]       # increasing [M*H]
    violated = np.asarray(mt.violated, np.float64)
    need = need_replicas(np.asarray(mt.rate, np.float64), cfg)
    fc_need = need_replicas(flat["fc_point"], cfg)      # NaN -> NaN-safe ops

    cause = np.full(M, -1, np.int8)
    resp = np.full(M, -1, np.int64)
    counts = {c: 0.0 for c in CAUSES}
    for m in np.nonzero(violated > 0)[0]:
        # Last decision whose ordered capacity was live by minute m.
        ds = int(np.searchsorted(abs_sec + cfg.startup_sec, 60.0 * m,
                                 side="right")) - 1
        ds = max(ds, 0)
        resp[m] = ds
        if flat["capacity_capped"][ds] > 0.5:
            c = "capacity_capped"
        elif _recent_down_below(flat, abs_sec, ds, m, need[m]):
            c = "cooldown_suppressed"
        elif flat["target"][ds] < flat["desired"][ds] - 0.5:
            c = "limiter_clamped"
        elif (np.isfinite(fc_need[ds]) and fc_need[ds] >= need[m]
              and flat["desired_raw"][ds] < need[m] - 0.5):
            c = "confidence_downscale"
        else:
            c = "under_forecast"
        cause[m] = CAUSES.index(c)
        counts[c] += float(violated[m])
    return Blame(cause=cause, responsible=resp, violated=violated,
                 need=need, counts=counts, total=float(violated.sum()))


def _recent_down_below(flat, abs_sec, ds, m, need_m) -> bool:
    """Did a scale-down executed in (responsible head, end of minute m]
    take the plant's target below the minute's need?"""
    lo, hi = ds + 1, int(np.searchsorted(abs_sec, 60.0 * (m + 1)))
    if lo >= hi:
        return False
    down = flat["scale_down"][lo:hi] > 0.5
    return bool(np.any(down & (flat["target"][lo:hi] < need_m - 0.5)))


def _fmt(x: float) -> str:
    return "n/a" if not np.isfinite(x) else f"{x:.1f}"


def blame_table(blames: dict) -> str:
    """{label: Blame} -> markdown table, one row per traced lane."""
    head = ["lane", "violated"] + list(CAUSES)
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    for label, b in blames.items():
        row = [label, f"{b.total:.0f}"]
        row += [f"{b.counts[c]:.0f}" for c in CAUSES]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def archetype_counts(ct: ControlTrace, blame: Blame,
                     into: dict | None = None) -> dict:
    """Per-archetype blame split of ONE lane, keyed by the archetype the
    controller reported at the responsible decision (aapa lanes; NaN
    archetypes — untyped policies — pool under 'untyped'). Pass `into`
    to merge several lanes into one table."""
    arch = np.asarray(ct.decisions.archetype, np.float64).reshape(-1)
    rows = {} if into is None else into
    for m in np.nonzero(blame.cause >= 0)[0]:
        a = arch[blame.responsible[m]]
        name = (ARCHETYPE_NAMES[int(a)] if np.isfinite(a)
                and 0 <= int(a) < len(ARCHETYPE_NAMES) else "untyped")
        row = rows.setdefault(name, {c: 0.0 for c in CAUSES})
        row[CAUSES[blame.cause[m]]] += float(blame.violated[m])
    return rows


def archetype_table(rows: dict) -> str:
    """Render `archetype_counts` rows as a markdown table."""
    head = ["archetype", "violated"] + list(CAUSES)
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    for name in sorted(rows):
        row = rows[name]
        cells = [name, f"{sum(row.values()):.0f}"]
        cells += [f"{row[c]:.0f}" for c in CAUSES]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def timeline(ct: ControlTrace, blame: Blame | None = None,
             max_rows: int = 64) -> str:
    """Markdown decision timeline of ONE lane: what each head saw and
    did. With `blame`, violated minutes are annotated with their cause;
    rows prioritize blamed minutes when the trace exceeds `max_rows`."""
    d = ct.decisions
    M, H = np.asarray(d.minute).shape
    f = {k: np.asarray(getattr(d, k), np.float64) for k in d._fields}
    flag_minutes = (set() if blame is None
                    else set(np.nonzero(blame.cause >= 0)[0].tolist()))
    minutes = list(range(M))
    if len(minutes) * H > max_rows:
        rest = [m for m in minutes if m not in flag_minutes]
        keep = max(max_rows // H - len(flag_minutes), 0)
        step = max(len(rest) // keep, 1) if keep else len(rest) + 1
        minutes = sorted(flag_minutes | set(rest[::step]))
    head = ["t", "rate/s", "fc/min", "conf", "ready", "desired",
            "target", "flags", "cause"]
    lines = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    for m in minutes:
        for h in range(H):
            flags = []
            if f["scale_up"][m, h] > 0.5:
                flags.append("up")
            if f["scale_down"][m, h] > 0.5:
                flags.append("down")
            if f["cooldown_blocked"][m, h] > 0.5:
                flags.append("cooldown")
            if f["capacity_capped"][m, h] > 0.5:
                flags.append("capped")
            c = ("" if blame is None or h or blame.cause[m] < 0
                 else CAUSES[blame.cause[m]])
            lines.append("| " + " | ".join([
                f"{int(f['minute'][m, h])}m{int(f['sec'][m, h]):02d}s",
                f"{f['rate_rps'][m, h]:.2f}", _fmt(f["fc_point"][m, h]),
                _fmt(f["confidence"][m, h]), f"{f['ready'][m, h]:.0f}",
                f"{f['desired'][m, h]:.0f}", f"{f['target'][m, h]:.0f}",
                " ".join(flags) or "-", c or "-"]) + " |")
    return "\n".join(lines)
