"""Render a solve trace into a human report; `--validate` gates it for CI
(port of `repro.obs.report`: the same schema, checks and output, so a
trace of either package passes either package's `validate`).

    python -m repro_torch.obs.report TRACE.jsonl [--validate] [--chrome OUT.json]

Sections:

  phase breakdown   wall time / count / bytes per span name — where the
                    solve went (operator applies vs subspace passes vs
                    SAFS fill/evict/retire);
  I/O vs compute    the §3.4.2 overlap story: prefetch busy/wait/overlap
                    seconds and the overlap fraction, plus the summed
                    prefetch-wait spans (the *un*-hidden remainder);
  convergence       the per-restart theta/residual table with the decay
                    ETA ("convergence.step" events);
  reconciliation    the summed bytes of every `pass.subspace` span
                    checked byte-exactly against the solve's
                    `IOStats.pass_bytes_read` delta — the tracer and the
                    counters are two independent accountants of the same
                    traffic and must agree to the byte.

  integrity         checksum-verification counters vs their trace
                    events: `crc_failures` must equal the number of
                    `safs.corrupt` events, `scrub_passes` the number of
                    `safs.scrub` events and `pages_repaired` the number
                    of `safs.repair` events — every detection, pass and
                    repair is both counted and announced, exactly once.

`--validate` exits non-zero on: schema mismatch, zero spans, an overlap
fraction outside [0, 1], or (on a lossless trace with a metrics record) a
failed byte or integrity reconciliation.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from repro_torch.obs.trace import SCHEMA, chrome_trace

PASS_SPAN = "pass.subspace"


def load(path: str) -> List[dict]:
    records = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: not JSON ({e})") from e
    return records


# ------------------------------------------------------------- accessors
def spans(records: List[dict]) -> List[dict]:
    return [r for r in records if r.get("type") == "span"]

def events(records: List[dict], name: str) -> List[dict]:
    return [r for r in records
            if r.get("type") == "event" and r.get("name") == name]

def metrics_records(records: List[dict]) -> List[dict]:
    return [r for r in records if r.get("type") == "metrics"]

def summary_record(records: List[dict]) -> Optional[dict]:
    for r in reversed(records):
        if r.get("type") == "summary":
            return r
    return None


def overlap_fractions(records: List[dict]) -> Dict[str, float]:
    """Every overlap fraction computable from the trace's metrics records
    (delta-of-solve preferred, end snapshot as fallback)."""
    out: Dict[str, float] = {}
    for i, m in enumerate(metrics_records(records)):
        data = m.get("data", {})
        for key in ("delta", "end"):
            snap = data.get(key)
            pf = ((snap or {}).get("backend") or {}).get("prefetch")
            if not pf:
                continue
            busy = pf.get("busy_seconds", 0.0)
            frac = (pf.get("overlap_seconds", 0.0) / busy) if busy > 0 else 0.0
            out[f"{m.get('name', 'metrics')}[{i}].{key}"] = frac
    return out


def reconcile(records: List[dict]) -> Optional[dict]:
    """Span-vs-IOStats pass accounting. Returns None when the trace has no
    solve metrics record to reconcile against."""
    delta_logical = None
    for m in metrics_records(records):
        d = m.get("data", {}).get("delta", {})
        if isinstance(d, dict) and "logical" in d:
            delta_logical = d["logical"]
    if delta_logical is None:
        return None
    span_bytes = 0
    span_count = 0
    for s in spans(records):
        if s["name"] == PASS_SPAN:
            span_count += 1
            span_bytes += int(s.get("args", {}).get("bytes", 0))
    summ = summary_record(records)
    lossless = summ is None or summ.get("dropped", 0) == 0
    return {
        "span_pass_count": span_count,
        "span_pass_bytes": span_bytes,
        "iostats_passes": delta_logical.get("passes"),
        "iostats_pass_bytes_read": delta_logical.get("pass_bytes_read"),
        "lossless": lossless,
        "exact": (span_count == delta_logical.get("passes")
                  and span_bytes == delta_logical.get("pass_bytes_read")),
    }


def integrity_reconcile(records: List[dict]) -> Optional[dict]:
    """Integrity counters vs corruption/scrub/repair trace events. Returns
    None when no metrics record carries a backend integrity block (ram
    backend, or a store without verify-on-read)."""
    integ = None
    for m in metrics_records(records):
        data = m.get("data", {})
        # prefer the absolute end snapshot: events count from process
        # start, and the backend is created inside the traced process
        for key in ("end", "delta"):
            cand = ((data.get(key) or {}).get("backend")
                    or {}).get("integrity")
            if isinstance(cand, dict):
                integ = cand
                break
    if integ is None:
        return None
    summ = summary_record(records)
    pairs = (("crc_failures", "safs.corrupt"),
             ("scrub_passes", "safs.scrub"),
             ("pages_repaired", "safs.repair"))
    out = {"lossless": summ is None or summ.get("dropped", 0) == 0}
    exact = True
    for counter, ev in pairs:
        got, want = integ.get(counter, 0), len(events(records, ev))
        out[counter] = got
        out[ev] = want
        exact = exact and got == want
    out["exact"] = exact
    return out


# ------------------------------------------------------------- validation
def validate(records: List[dict]) -> List[str]:
    """Schema/consistency problems, empty when the trace is good."""
    problems: List[str] = []
    if not records:
        return ["empty trace"]
    meta = records[0]
    if meta.get("type") != "meta":
        problems.append("first record is not a meta header")
    elif meta.get("schema") != SCHEMA:
        problems.append(f"schema {meta.get('schema')!r} != {SCHEMA!r}")
    n_spans = len(spans(records))
    if n_spans == 0:
        problems.append("no spans recorded")
    for s in spans(records):
        if s.get("dur", 0) < 0:
            problems.append(f"negative duration span {s['name']!r}")
            break
    for key, frac in overlap_fractions(records).items():
        if not (0.0 <= frac <= 1.0):
            problems.append(f"overlap fraction {key}={frac} outside [0, 1]")
    rec = reconcile(records)
    if rec is not None and rec["lossless"] and not rec["exact"]:
        problems.append(
            f"pass accounting mismatch: {rec['span_pass_count']} spans / "
            f"{rec['span_pass_bytes']} B vs IOStats "
            f"{rec['iostats_passes']} passes / "
            f"{rec['iostats_pass_bytes_read']} B")
    integ = integrity_reconcile(records)
    if integ is not None and integ["lossless"] and not integ["exact"]:
        problems.append(
            "integrity accounting mismatch: counters "
            f"crc_failures={integ['crc_failures']}/"
            f"scrub_passes={integ['scrub_passes']}/"
            f"pages_repaired={integ['pages_repaired']} vs events "
            f"safs.corrupt={integ['safs.corrupt']}/"
            f"safs.scrub={integ['safs.scrub']}/"
            f"safs.repair={integ['safs.repair']}")
    return problems


# --------------------------------------------------------------- rendering
def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def phase_table(records: List[dict]) -> List[tuple]:
    """(name, count, total_ms, total_bytes) per span name, by time desc."""
    agg: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0])
    for s in spans(records):
        a = agg[s["name"]]
        a[0] += 1
        a[1] += s.get("dur", 0.0) / 1e3
        b = s.get("args", {}).get("bytes")
        if isinstance(b, (int, float)):
            a[2] += b
    return sorted(((k, int(v[0]), v[1], int(v[2]))
                   for k, v in agg.items()), key=lambda r: -r[2])


def render(records: List[dict]) -> str:
    lines: List[str] = []
    meta = records[0] if records else {}
    summ = summary_record(records) or {}
    lines.append("== solve report ==")
    lines.append(f"schema {meta.get('schema')} · "
                 f"{summ.get('spans', len(spans(records)))} spans · "
                 f"{summ.get('events', 0)} events · "
                 f"{summ.get('dropped', 0)} dropped")

    lines.append("")
    lines.append("-- phase breakdown (by wall time) --")
    lines.append(f"{'span':<24} {'count':>7} {'total ms':>10} {'bytes':>12}")
    for name, count, ms, nbytes in phase_table(records):
        lines.append(f"{name:<24} {count:>7} {ms:>10.2f} "
                     f"{_fmt_bytes(nbytes) if nbytes else '-':>12}")

    fracs = overlap_fractions(records)
    wait_ms = sum(s.get("dur", 0.0) for s in spans(records)
                  if s["name"] == "safs.prefetch_wait") / 1e3
    fill_ms = sum(s.get("dur", 0.0) for s in spans(records)
                  if s["name"] == "safs.fill") / 1e3
    lines.append("")
    lines.append("-- I/O vs compute (§3.4.2) --")
    if fracs:
        for key, frac in fracs.items():
            lines.append(f"overlap fraction {key}: {frac:.3f}")
    else:
        lines.append("no prefetch metrics in trace")
    lines.append(f"prefetch fill time {fill_ms:.2f} ms on workers; "
                 f"un-hidden wait {wait_ms:.2f} ms on the consumer")

    conv = events(records, "convergence.step")
    lines.append("")
    lines.append("-- convergence --")
    if conv:
        lines.append(f"{'step':>5} {'worst rel res':>14} {'theta[0]':>12} "
                     f"{'eta steps':>10}")
        for e in conv:
            a = e.get("args", {})
            r = a.get("res_max_rel")
            th = (a.get("theta") or [None])[0]
            eta = a.get("eta_steps")
            lines.append(
                f"{a.get('step', '?'):>5} "
                f"{('%.3e' % r) if r is not None else 'inf':>14} "
                f"{('%.6f' % th) if th is not None else '-':>12} "
                f"{eta if eta is not None else '-':>10}")
    else:
        lines.append("no convergence events in trace")

    rec = reconcile(records)
    lines.append("")
    lines.append("-- pass-byte reconciliation (spans vs IOStats) --")
    if rec is None:
        lines.append("no solve metrics record in trace")
    else:
        lines.append(
            f"spans: {rec['span_pass_count']} passes / "
            f"{_fmt_bytes(rec['span_pass_bytes'])}; IOStats: "
            f"{rec['iostats_passes']} passes / "
            f"{_fmt_bytes(rec['iostats_pass_bytes_read'] or 0)} → "
            + ("EXACT" if rec["exact"] else
               ("MISMATCH" if rec["lossless"] else "lossy trace, skipped")))

    integ = integrity_reconcile(records)
    lines.append("")
    lines.append("-- integrity (counters vs trace events) --")
    if integ is None:
        lines.append("no integrity metrics in trace")
    else:
        lines.append(
            f"corrupt {integ['crc_failures']}/{integ['safs.corrupt']} · "
            f"scrub passes {integ['scrub_passes']}/{integ['safs.scrub']} · "
            f"repairs {integ['pages_repaired']}/{integ['safs.repair']} → "
            + ("EXACT" if integ["exact"] else
               ("MISMATCH" if integ["lossless"] else
                "lossy trace, skipped")))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render/validate a repro_torch.obs JSONL trace")
    ap.add_argument("trace", help="JSONL trace (Tracer.write_jsonl)")
    ap.add_argument("--validate", action="store_true",
                    help="exit non-zero on schema/consistency problems")
    ap.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="also write a Chrome trace-event conversion")
    args = ap.parse_args(argv)
    records = load(args.trace)
    print(render(records))
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(chrome_trace(records), f)
        print(f"\nchrome trace written to {args.chrome} "
              f"(open in https://ui.perfetto.dev)")
    if args.validate:
        problems = validate(records)
        if problems:
            print("\nVALIDATION FAILED:", file=sys.stderr)
            for p in problems:
                print(f"  - {p}", file=sys.stderr)
            return 1
        print("\nvalidation OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
