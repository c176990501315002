"""Prometheus text-exposition rendering of a registry snapshot, as
``fmda_tpu.obs.prometheus`` renders it (the same text, byte for byte, for
the same snapshot).

Renders the format scraped by Prometheus/`promtool` (text exposition
v0.0.4): counters and gauges as single samples, latency histograms as
*summary* families (pre-computed p50/p99 quantiles + ``_sum``/``_count``)
— the registry's fixed-bin histograms already reduce to quantiles, and a
summary costs 4 lines instead of 80 bucket lines per series.

Metric names are prefixed ``fmda_`` and sanitised to the Prometheus
grammar (``[a-zA-Z_:][a-zA-Z0-9_:]*``); label values are escaped per the
spec (backslash, double-quote, newline).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

from fmda_tpu_torch.obs.registry import Sample, Snapshot

PREFIX = "fmda_"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def _name(raw: str) -> str:
    name = PREFIX + raw
    if not _NAME_OK.match(name):
        name = _NAME_BAD_CHARS.sub("_", name)
        if not _NAME_OK.match(name):
            name = "_" + name
    return name


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r'\"')
    )


def _labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _value(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: Snapshot, *, exemplars: bool = False) -> str:
    """Registry snapshot -> text exposition (one ``# TYPE`` line per
    family, samples grouped under it).

    ``exemplars=True`` appends OpenMetrics exemplar syntax
    (``# {trace_id="..."} value``) to the bucket lines of histogram
    samples that carry them (the tracer's ``e2e_tick_seconds``).  That
    suffix is **illegal in text exposition v0.0.4** — the legacy parser
    expects at most a timestamp after the value and fails the whole
    scrape — so callers must only enable it for clients that negotiated
    an OpenMetrics response (the ``/metrics`` endpoint checks the
    ``Accept`` header); the default rendering stays 0.0.4-clean (the
    bucketed histogram form itself is legal there)."""
    by_family: Dict[str, tuple] = {}  # name -> (type, [lines])

    def family(name: str, kind: str) -> List[str]:
        entry = by_family.get(name)
        if entry is None:
            entry = by_family[name] = (kind, [])
        return entry[1]

    for s in snapshot.get("counters", ()):
        name = _name(str(s["name"]))
        family(name, "counter").append(
            f"{name}{_labels(s.get('labels', {}))} {_value(s['value'])}"
        )
    for s in snapshot.get("gauges", ()):
        name = _name(str(s["name"]))
        family(name, "gauge").append(
            f"{name}{_labels(s.get('labels', {}))} {_value(s['value'])}"
        )
    for s in snapshot.get("histograms", ()):
        name = _name(str(s["name"]))
        labels = s.get("labels", {})
        buckets = s.get("buckets")
        if buckets:
            # bucketed exposition for series carrying sample-linked
            # exemplars (the tracer's e2e_tick_seconds): sparse
            # cumulative `le` buckets, each annotated with its last
            # trace id in OpenMetrics exemplar syntax — the scrape-side
            # bridge from "p99 is bad" to "trace THIS tick"
            lines = family(name, "histogram")
            for b in buckets:
                le = b["le"]
                extra = 'le="%s"' % (
                    le if isinstance(le, str) else _value(le))
                line = (f"{name}_bucket{_labels(labels, extra)} "
                        f"{_value(b['count'])}")
                ex = b.get("exemplar")
                if exemplars and ex:
                    line += (' # {trace_id="%s"} %s'
                             % (_escape_label(ex["trace_id"]),
                                _value(ex["value_s"])))
                lines.append(line)
        else:
            lines = family(name, "summary")
            for q, key in (("0.5", "p50_s"), ("0.99", "p99_s")):
                extra = 'quantile="%s"' % q
                lines.append(
                    f"{name}{_labels(labels, extra)} {_value(s[key])}"
                )
        lines.append(f"{name}_sum{_labels(labels)} {_value(s['sum_s'])}")
        lines.append(f"{name}_count{_labels(labels)} {_value(s['count'])}")

    out: List[str] = []
    for name in sorted(by_family):
        kind, lines = by_family[name]
        out.append(f"# TYPE {name} {kind}")
        out.extend(lines)
    return "\n".join(out) + ("\n" if out else "")
