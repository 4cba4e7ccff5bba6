"""Perf regression sentinel: a rolling fingerprint ledger and a
noise-band comparison, so "did this run get slower than the last one?"
has a machine answer.

Counterpart of ``trustworthy_dl_tpu/obs/sentinel.py``: the same
fingerprint schema, metrics and directions, band, metric, event and diff
rendering.  Every finishing instrumented run appends one compact
**fingerprint** — tokens/s, step time, phase fractions, compile
counts/seconds, device-memory watermark — to ``PERF_LEDGER.jsonl``
(``ObsSession.finalize``), under a ``key`` (producer, headline metric,
platform, device kind) so a CPU debug run never bands against a run on
the card.  The sentinel compares a fresh fingerprint against the ledger's
recent entries for the same key: a metric outside
``max(nsigma·std, rel_floor·mean)`` of the baseline mean in its BAD
direction is a regression — typed ``perf_regression`` events and
``tddl_perf_regressions_total{metric=}``.  The fingerprint's
``run_metadata`` carries ``torch_version`` and ``cuda_version`` where
JAX's carries ``jax_version``.

Host-only: nothing here imports torch; ``python -m
trustworthy_dl_tpu_torch.cli obs diff A B`` renders two artifact sets
(obs_report.json / ledger fingerprints) side by side offline.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from trustworthy_dl_tpu_torch.obs.events import EventType

FINGERPRINT_SCHEMA = "tddl-perf-v1"

#: metric -> direction ("higher" = bigger is better).  Only metrics a
#: fingerprint actually carries are checked.
SENTINEL_METRICS: Dict[str, str] = {
    "tokens_per_s": "higher",
    "step_time_s": "lower",
    "compile_total": "lower",
    "compile_seconds": "lower",
    "hbm_watermark_bytes": "lower",
    # Speculative-decode draft quality: the fraction of drafted tokens
    # the model-dtype verify accepted (names its cause before tokens/s
    # shows it).
    "accepted_rate": "higher",
    # Decode, prefill-chunk and speculative-verify shares of the serve
    # wall: a program that slows (a kernel path dropped, a launch that
    # grew) inflates its own share first.
    "decode_tick_fraction": "lower",
    "prefill_chunk_fraction": "lower",
    "spec_verify_fraction": "lower",
    # Adapter-pool locality (pool hits / lookups) and the equal-memory
    # personalisation cost (adapter-arm over base-arm tokens/s).
    "adapter_hit_rate": "higher",
    "adapter_tokens_ratio": "higher",
    # Live-migration success under capacity loss (a fleet metric; no
    # port producer until the fleet is ported).
    "migration_fraction": "higher",
}


def fingerprint(source: str, *, metric: Optional[str] = None,
                tokens_per_s: Optional[float] = None,
                step_time_s: Optional[float] = None,
                phase_fractions: Optional[Dict[str, float]] = None,
                compile_total: Optional[int] = None,
                compile_seconds: Optional[float] = None,
                hbm_watermark_bytes: Optional[int] = None,
                accepted_rate: Optional[float] = None,
                decode_tick_fraction: Optional[float] = None,
                prefill_chunk_fraction: Optional[float] = None,
                spec_verify_fraction: Optional[float] = None,
                adapter_hit_rate: Optional[float] = None,
                adapter_tokens_ratio: Optional[float] = None,
                migration_fraction: Optional[float] = None,
                run_metadata: Optional[Dict[str, Any]] = None,
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One compact perf fingerprint.  ``key`` scopes comparability:
    same producer, same headline metric, same platform/device kind."""
    meta = run_metadata or {}
    key = ":".join([
        str(source), str(metric or "-"),
        str(meta.get("platform", "?")), str(meta.get("device_kind", "?")),
    ])
    fp: Dict[str, Any] = {
        "schema": FINGERPRINT_SCHEMA,
        # A wall stamp for humans reading PERF_LEDGER.jsonl; never a
        # comparison input (the sentinel bands on values keyed by ``key``).
        "t": time.time(),
        "source": source,
        "key": key,
    }
    if metric is not None:
        fp["metric"] = metric
    for name, value in (("tokens_per_s", tokens_per_s),
                        ("step_time_s", step_time_s),
                        ("compile_total", compile_total),
                        ("compile_seconds", compile_seconds),
                        ("hbm_watermark_bytes", hbm_watermark_bytes),
                        ("accepted_rate", accepted_rate),
                        ("decode_tick_fraction", decode_tick_fraction),
                        ("prefill_chunk_fraction", prefill_chunk_fraction),
                        ("spec_verify_fraction", spec_verify_fraction),
                        ("adapter_hit_rate", adapter_hit_rate),
                        ("adapter_tokens_ratio", adapter_tokens_ratio),
                        ("migration_fraction", migration_fraction)):
        if value is not None:
            fp[name] = float(value)
    if phase_fractions:
        fp["phase_fractions"] = {k: round(float(v), 4)
                                 for k, v in phase_fractions.items()}
    if meta:
        fp["run_metadata"] = {
            k: meta[k] for k in ("platform", "device_kind", "num_devices",
                                 "torch_version", "cuda_version",
                                 "framework_version")
            if k in meta
        }
    if extra:
        fp.update(extra)
    return fp


class PerfLedger:
    """Rolling JSONL of fingerprints.  ``keep`` bounds the FILE: an
    append that pushes past it rewrites the tail — the ledger is a
    trajectory window, not an archive."""

    def __init__(self, path: str, keep: int = 512):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.path = str(path)
        self.keep = keep

    def read(self) -> List[Dict[str, Any]]:
        entries: List[Dict[str, Any]] = []
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entries.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # a torn line loses one row, not the file
        except OSError:
            pass
        return entries

    def append(self, fp: Dict[str, Any]) -> Dict[str, Any]:
        entries = self.read()
        entries.append(fp)
        if len(entries) > self.keep:
            entries = entries[-self.keep:]
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for entry in entries:
                f.write(json.dumps(entry) + "\n")
        os.replace(tmp, self.path)
        return fp

    def baseline(self, key: str, limit: int = 20
                 ) -> List[Dict[str, Any]]:
        """The most recent ``limit`` prior entries for ``key`` (newest
        last).  Entries already marked regressed are EXCLUDED — a
        confirmed-bad round must not drag the band down to itself."""
        rows = [e for e in self.read()
                if e.get("key") == key and not e.get("regressed")]
        return rows[-limit:]

    def last(self, key: Optional[str] = None) -> Optional[Dict[str, Any]]:
        rows = self.read()
        if key is not None:
            rows = [e for e in rows if e.get("key") == key]
        return rows[-1] if rows else None


class PerfSentinel:
    """Noise-band comparison of one fingerprint against the ledger."""

    def __init__(self, ledger: PerfLedger, *, min_baseline: int = 3,
                 nsigma: float = 3.0, rel_floor: float = 0.05,
                 trace: Any = None, registry: Any = None):
        self.ledger = ledger
        self.min_baseline = min_baseline
        self.nsigma = nsigma
        self.rel_floor = rel_floor
        self.trace = trace
        self._regression_metric = None
        if registry is not None:
            self._regression_metric = registry.counter(
                "tddl_perf_regressions_total",
                "Fingerprint metrics outside the ledger noise band",
                labels=("metric",),
            )

    def check(self, fp: Dict[str, Any]) -> Dict[str, Any]:
        """Verdict: per-metric baseline mean / band / regressed flags.
        Fewer than ``min_baseline`` comparable prior rows → everything
        passes (no band to be outside of) and ``baseline_n`` says so."""
        baseline = self.ledger.baseline(fp.get("key", ""))
        checks: List[Dict[str, Any]] = []
        regressed = False
        for name, direction in SENTINEL_METRICS.items():
            value = fp.get(name)
            if value is None:
                continue
            values = [float(e[name]) for e in baseline if name in e]
            if len(values) < self.min_baseline:
                checks.append({"metric": name, "value": float(value),
                               "baseline_n": len(values),
                               "regressed": False})
                continue
            mean = sum(values) / len(values)
            var = sum((v - mean) ** 2 for v in values) / len(values)
            band = max(self.nsigma * math.sqrt(var),
                       self.rel_floor * abs(mean))
            if direction == "higher":
                bad = float(value) < mean - band
            else:
                bad = float(value) > mean + band
            delta_pct = ((float(value) - mean) / mean * 100.0
                         if mean else 0.0)
            checks.append({
                "metric": name, "value": float(value),
                "baseline_mean": mean, "band": band,
                "baseline_n": len(values), "direction": direction,
                "delta_pct": round(delta_pct, 2), "regressed": bad,
            })
            if bad:
                regressed = True
                if self._regression_metric is not None:
                    self._regression_metric.inc(metric=name)
                if self.trace is not None:
                    self.trace.emit(EventType.PERF_REGRESSION, metric=name,
                                    value=float(value), baseline=mean,
                                    band=band, key=fp.get("key"),
                                    delta_pct=round(delta_pct, 2))
        return {
            "key": fp.get("key"),
            "baseline_n": len(baseline),
            "regressed": regressed,
            "checks": checks,
        }


# ---------------------------------------------------------------------------
# Offline diff (the body of ``cli obs diff A B``)
# ---------------------------------------------------------------------------


def load_perf_artifact(path: str) -> Dict[str, Any]:
    """One comparable perf view from an artifact path: an obs dir
    (obs_report.json + PERF_LEDGER.jsonl), an obs_report.json, or a
    perf-ledger JSONL (last fingerprint)."""
    out: Dict[str, Any] = {"path": path}
    report_path = ledger_path = None
    if os.path.isdir(path):
        report_path = os.path.join(path, "obs_report.json")
        ledger_path = os.path.join(path, "PERF_LEDGER.jsonl")
    elif path.endswith(".jsonl"):
        ledger_path = path
    else:
        report_path = path
    if report_path and os.path.exists(report_path):
        with open(report_path) as f:
            out["report"] = json.load(f)
    if ledger_path and os.path.exists(ledger_path):
        fp = PerfLedger(ledger_path).last()
        if fp is not None:
            out["fingerprint"] = fp
    if "report" not in out and "fingerprint" not in out:
        raise FileNotFoundError(
            f"{path!r} holds neither an obs_report.json nor a perf "
            "ledger fingerprint"
        )
    return out


def _flatten_perf(view: Dict[str, Any]) -> "List[Tuple[str, Any]]":
    """Comparable (label, value) rows from one artifact view."""
    rows: List[Tuple[str, Any]] = []
    report = view.get("report") or {}
    fp = view.get("fingerprint") or {}

    def add(label: str, value: Any) -> None:
        if value is not None:
            rows.append((label, value))

    step = report.get("step_time_s") or {}
    add("step_time_mean_s", step.get("mean") or fp.get("step_time_s"))
    add("step_time_p95_s", step.get("p95"))
    mfu = report.get("mfu") or {}
    if isinstance(mfu, dict):
        add("tokens_per_s_per_chip", mfu.get("tokens_per_s_per_chip"))
        add("mfu_nominal", mfu.get("mfu"))
    analyzed = report.get("mfu_analyzed") or {}
    if isinstance(analyzed, dict):
        add("mfu_analyzed", analyzed.get("mfu"))
    for phase, stats in sorted((report.get("phases") or {}).items()):
        add(f"phase_{phase}_fraction", stats.get("fraction"))
    for name, cost in sorted((report.get("cost_ledger") or {}).items()):
        add(f"flops[{name}]", cost.get("flops"))
        add(f"temp_bytes[{name}]", cost.get("temp_bytes"))
    compile_block = report.get("compile") or {}
    add("compile_total",
        compile_block.get("total", fp.get("compile_total")))
    add("compile_seconds",
        compile_block.get("seconds", fp.get("compile_seconds")))
    hbm = report.get("hbm") or {}
    add("hbm_watermark_bytes",
        hbm.get("watermark_bytes", fp.get("hbm_watermark_bytes")))
    add("tokens_per_s", fp.get("tokens_per_s"))
    add("accepted_rate", fp.get("accepted_rate"))
    add("decode_tick_fraction", fp.get("decode_tick_fraction"))
    return rows


def render_diff(a: Dict[str, Any], b: Dict[str, Any]) -> str:
    """Two artifact views side by side with relative deltas — the obs
    CLI prints this verbatim."""
    rows_a = dict(_flatten_perf(a))
    rows_b = dict(_flatten_perf(b))
    labels = list(rows_a) + [k for k in rows_b if k not in rows_a]
    name_a = a.get("path", "A")
    name_b = b.get("path", "B")
    width = max([len(label) for label in labels] + [6])
    lines = [f"A: {name_a}", f"B: {name_b}",
             f"{'':{width}}  {'A':>14}  {'B':>14}  {'delta':>9}",
             "-" * (width + 43)]

    def fmt(v: Any) -> str:
        if v is None:
            return "-"
        if isinstance(v, float):
            if v and (abs(v) >= 1e5 or abs(v) < 1e-3):
                return f"{v:.3e}"
            return f"{v:.4f}"
        return str(v)

    for label in labels:
        va, vb = rows_a.get(label), rows_b.get(label)
        delta = "-"
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)) \
                and va:
            delta = f"{(vb - va) / abs(va) * 100.0:+.1f}%"
        lines.append(f"{label:{width}}  {fmt(va):>14}  {fmt(vb):>14}  "
                     f"{delta:>9}")
    return "\n".join(lines)


__all__ = ["FINGERPRINT_SCHEMA", "PerfLedger", "PerfSentinel",
           "SENTINEL_METRICS", "fingerprint", "load_perf_artifact",
           "render_diff"]
