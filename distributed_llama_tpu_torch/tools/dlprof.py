#!/usr/bin/env python
"""dlprof — the offline latency and capacity analyzer over the flight
recorder's files, a stdlib-only copy of the repo's tools/dlprof.py that
reads the port's ``--trace-dir`` output (runtime/trace.py's TraceSink
writes the JAX package's schema).

Inputs (any combination; at least one):

  * ``--trace-dir DIR``: the rotating JSONL that ``dllama api --trace
    --trace-dir DIR`` writes: request spans and the per-step timeline.
  * ``--bench FILE``: a benchmark artifact (one JSON object, or a list of
    rows): every row's ``step_timeline`` block feeds the curve, its
    ``hbm`` block caps the recommendation.

The report (JSON, and markdown with ``--out``) has four sections:

  * the per-request critical path: each completed span split into queue,
    route, seed, prefill, first token and decode, with percentiles;
  * the batch-composition -> ms/step curve and its knee: the largest
    batch whose marginal throughput per added row still clears half the
    small-batch per-row throughput, with a ``--serve-batch``
    recommendation;
  * goodput at the SLOs (``--slo-ttft-ms``, ``--slo-itl-ms``);
  * tail attribution: the slowest requests, each with the phase that ate
    its budget.

With ``--autotune FILE`` the report compares the artifact's calibrated
knee with the measured one and flags a drift of 25% or more. With
``--wire`` it adds the measured cluster-plane section: per-peer bytes,
frames, heartbeat RTT tails and clock offsets from the rows' ``wire``
blocks (a cluster root's /stats, the chaos harness's ``complete`` stats),
the sampled device sync-vs-compute share from ``sync`` trace events, and
every measured-vs-modeled reconciliation, drift flagged at 25%, and the
"KV transfer" part: fills, bytes moved, transfer tails and the prefill
tier's passes from the rows' ``kv_transfer`` blocks.

Pure host-side file crunching: it imports nothing of the package, so it
runs with the file alone. ``--selftest`` synthesizes a tiny trace and
timeline and checks the report.

Usage:
  python -m distributed_llama_tpu_torch.tools.dlprof --trace-dir DIR \\
      --out report --slo-ttft-ms 500
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

# -- small stats helpers (no package import: dlprof runs as a lone file,
# next to an artifact) -------------------------------------------------------


def percentile(xs: list, p: float):
    """Nearest-rank percentile, the same convention as
    runtime/stats.percentile (no interpolation; None when empty)."""
    if not xs:
        return None
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, round(p / 100.0 * (len(xs) - 1))))
    return xs[k]


def _rnd(v, nd: int = 3):
    return None if v is None else round(v, nd)


# -- input loading ----------------------------------------------------------


def load_trace_dir(path: str) -> list[dict]:
    """Every event from every ``trace-*.jsonl`` under `path` (recursive —
    replica workers write ``worker-rK/`` subdirs), sorted by wall time
    so cross-process events interleave correctly."""
    events: list[dict] = []
    for f in glob.glob(os.path.join(path, "**", "trace-*.jsonl"),
                       recursive=True):
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn final line in a live sink
                if "kind" in rec:
                    events.append(rec)
    events.sort(key=lambda e: e.get("ts_wall", e.get("ts", 0.0)))
    return events


_TL_KEY = re.compile(r"^(?:r\d+_)?dec(\d+)_pre(\d+)_c(\d+)$")


def load_bench(path: str) -> list[dict]:
    """bench.py artifact -> flat row list (the main row + its variants).
    Accepts the one-object-per-run shape bench prints and committed
    BENCH_rXX.json artifacts of the same shape."""
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, list):
        rows = list(obj)
    else:
        rows = [obj] + list(obj.get("variants") or [])
    return [r for r in rows if isinstance(r, dict)]


def merge_timelines(events: list[dict], bench_rows: list[dict]) -> dict:
    """{(dec, pre, chunk): {"n", "p50_ms", "p99_ms", "mean_ms"}} merged
    from raw step events (exact — re-percentiled here) and bench rows'
    pre-summarized ``step_timeline`` blocks (worker ``rK_`` prefixes
    stripped; when several sources cover one composition the larger-n
    summary wins)."""
    raw: dict[tuple, list] = {}
    for e in events:
        if e.get("kind") != "step":
            continue
        key = (int(e.get("dec", 0)), int(e.get("pre", 0)),
               int(e.get("chunk", 0)))
        raw.setdefault(key, []).append(float(e.get("ms", 0.0)))
    out: dict[tuple, dict] = {}
    for key, xs in raw.items():
        out[key] = {"n": len(xs), "p50_ms": _rnd(percentile(xs, 50), 4),
                    "p99_ms": _rnd(percentile(xs, 99), 4),
                    "mean_ms": _rnd(sum(xs) / len(xs), 4)}
    for row in bench_rows:
        for k, v in (row.get("step_timeline") or {}).items():
            m = _TL_KEY.match(str(k))
            if not m or not isinstance(v, dict):
                continue
            key = tuple(int(g) for g in m.groups())
            if key not in out or (v.get("n", 0) > out[key].get("n", 0)):
                out[key] = {"n": v.get("n", 0),
                            "p50_ms": v.get("p50_ms"),
                            "p99_ms": v.get("p99_ms"),
                            "mean_ms": v.get("mean_ms")}
    return out


# -- per-request critical path ----------------------------------------------

_TERMINAL = ("finish", "error")


def spans_from_events(events: list[dict]) -> dict[int, list[dict]]:
    spans: dict[int, list[dict]] = {}
    for e in events:
        tid = e.get("tid") or 0
        if tid:
            spans.setdefault(int(tid), []).append(e)
    return spans


def critical_path(span: list[dict]) -> dict | None:
    """One span -> its phase decomposition (ms). None when the span has
    no terminal event (still in flight when the sink rotated, or a
    SIGKILL casualty whose retry carried the id — the RETRY's terminal
    closes the span, so those still analyze)."""

    def first(kind):
        return next((e for e in span if e.get("kind") == kind), None)

    def ts(e):
        return e.get("ts_wall", e.get("ts")) if e is not None else None

    term = next((e for e in reversed(span)
                 if e.get("kind") in _TERMINAL), None)
    enq = first("enqueue")
    if term is None or enq is None:
        return None
    admit = first("admit")
    route = first("route")
    seed = first("seed")
    ft = first("first_token")
    t0, t_end = ts(enq), ts(term)
    t_admit, t_ft = ts(admit), ts(ft)
    queue_ms = (admit.get("queue_ms") if admit is not None else None)
    if queue_ms is None and t_admit is not None:
        queue_ms = (t_admit - t0) * 1e3
    prefill_ms = ((t_ft - t_admit) * 1e3
                  if t_ft is not None and t_admit is not None else None)
    decode_ms = (t_end - t_ft) * 1e3 if t_ft is not None else None
    n_out = int(term.get("n_out") or 0)
    retries = sum(1 for e in span if e.get("kind") == "failover")
    out = {
        "tid": span[0].get("tid"),
        "status": (term.get("reason") if term.get("kind") == "finish"
                   else f"error:{term.get('code', 'error')}"),
        "n_prompt": enq.get("n_prompt"),
        "n_out": n_out,
        "seed_hit": seed.get("hit") if seed is not None else None,
        "retries": retries,
        "queue_ms": _rnd(queue_ms),
        "route_ms": _rnd((ts(route) - t0) * 1e3
                         if route is not None else None),
        "prefill_ms": _rnd(prefill_ms),
        "ttft_ms": _rnd(ft.get("ttft_ms") if ft is not None
                        else ((t_ft - t0) * 1e3 if t_ft is not None
                              else None)),
        "decode_ms": _rnd(decode_ms),
        "itl_ms": _rnd(decode_ms / (n_out - 1)
                       if decode_ms is not None and n_out > 1 else None),
        "total_ms": _rnd((t_end - t0) * 1e3),
    }
    phases = {k: out[k] for k in ("queue_ms", "prefill_ms", "decode_ms")
              if out.get(k) is not None}
    out["dominant_phase"] = (max(phases, key=phases.get).removesuffix("_ms")
                            if phases else None)
    return out


def request_summary(paths: list[dict]) -> dict:
    def pcts(field):
        xs = [p[field] for p in paths if p.get(field) is not None]
        return {"n": len(xs), "p50": _rnd(percentile(xs, 50)),
                "p99": _rnd(percentile(xs, 99))}

    return {
        "requests": len(paths),
        "completed": sum(1 for p in paths
                         if not str(p["status"]).startswith("error")),
        "errors": sum(1 for p in paths
                      if str(p["status"]).startswith("error")),
        "retried": sum(1 for p in paths if p.get("retries")),
        "queue_ms": pcts("queue_ms"),
        "prefill_ms": pcts("prefill_ms"),
        "ttft_ms": pcts("ttft_ms"),
        "itl_ms": pcts("itl_ms"),
        "decode_ms": pcts("decode_ms"),
        "total_ms": pcts("total_ms"),
    }


# -- the batch knee ---------------------------------------------------------


def decode_curve(timeline: dict) -> list[tuple[int, float]]:
    """Decode-only compositions -> sorted (rows, p50 ms) points (the
    batch-composition → ms/step curve; prefill-mixed compositions are
    admission noise for this question)."""
    pts = [(k[0], v["p50_ms"]) for k, v in timeline.items()
           if k[0] > 0 and k[1] == 0 and v.get("p50_ms")]
    return sorted(pts)


def knee_estimate(curve: list[tuple[int, float]]) -> dict | None:
    """Where batching stops paying. Decode is weight-read-bound, so
    ms/step should be nearly flat in rows until KV-cache traffic starts
    competing; the knee is the largest measured batch whose MARGINAL
    aggregate throughput per added row still clears half the small-batch
    per-row throughput. Emits the whole throughput table so the caller
    (and ROADMAP item 1's auto-sizing) can re-derive with its own
    threshold. None only when no decode composition was measured."""
    if not curve:
        return None
    table = [{"rows": b, "p50_ms": ms,
              "rows_per_s": _rnd(b / ms * 1e3, 2)} for b, ms in curve]
    if len(curve) == 1:
        b, ms = curve[0]
        return {"knee_rows": b, "method": "single_point",
                "curve": table,
                "note": "one composition measured — bench more batch "
                        "sizes (BENCH_SERVE with a larger --serve-batch) "
                        "to place the knee"}
    b0, ms0 = curve[0]
    per_row0 = (b0 / ms0) / b0          # rows/ms each small-batch row buys
    knee = b0
    saturated = False
    for (b1, m1), (b2, m2) in zip(curve, curve[1:]):
        t1, t2 = b1 / m1, b2 / m2
        marginal = (t2 - t1) / (b2 - b1)
        if marginal < 0.5 * per_row0:
            saturated = True
            break
        knee = b2
    return {"knee_rows": knee,
            "method": "marginal_throughput" if saturated
            else "no_saturation_observed",
            "curve": table,
            "note": None if saturated else
            f"throughput still scaling at rows={knee} — measure larger "
            "batches to find the true knee"}


# -- the calibration artifact (tools/autotune.py) ---------------------------

# the artifact's contract (JAX runtime/profiler.py:391-437); the port's
# runtime/profiler.py imports it from here, and dlprof stays a lone
# stdlib file.
AUTOTUNE_KIND = "dllama-autotune"
AUTOTUNE_VERSION = 1
DRIFT_FRAC = 0.25  # calibrated vs measured knee movement worth flagging


def validate_autotune(art) -> list[str]:
    """Schema problems of one AUTOTUNE.json artifact (empty = valid)."""
    problems = []
    if not isinstance(art, dict):
        return ["not a JSON object"]
    if art.get("kind") != AUTOTUNE_KIND:
        problems.append(f"kind must be {AUTOTUNE_KIND!r}, "
                        f"got {art.get('kind')!r}")
    if art.get("version") != AUTOTUNE_VERSION:
        problems.append(f"version must be {AUTOTUNE_VERSION}, "
                        f"got {art.get('version')!r}")
    knee = art.get("knee")
    if not isinstance(knee, dict) or not knee.get("knee_rows"):
        problems.append("missing knee.knee_rows (re-run the calibration "
                        "with >= 1 measured batch size)")
    if not isinstance(art.get("decode_curve"), list):
        problems.append("missing decode_curve list")
    return problems


def load_autotune(path: str) -> dict:
    """Read and validate an autotune artifact. Raises ValueError naming
    every schema problem: a bad artifact is a startup error, never a
    wrong batch size."""
    with open(path) as f:
        art = json.load(f)
    problems = validate_autotune(art)
    if problems:
        raise ValueError("invalid autotune artifact: "
                         + "; ".join(problems))
    return art


def autotune_comparison(knee: dict | None, art: dict) -> dict:
    """Calibrated knee (AUTOTUNE.json) vs the knee measured from the
    LIVE inputs of this report — the drift check an operator runs before
    trusting yesterday's calibration: a knee moved >= DRIFT_FRAC means
    the workload, model, or backend shifted enough that the auto-sized
    batch is stale and tools/autotune.py should re-run."""
    calibrated = int((art.get("knee") or {}).get("knee_rows") or 0)
    measured = int(knee["knee_rows"]) if knee else None
    drift_frac = None
    drift = False
    if measured is not None and calibrated:
        drift_frac = abs(measured - calibrated) / calibrated
        drift = drift_frac >= DRIFT_FRAC
    return {
        "calibrated_knee_rows": calibrated or None,
        "calibrated_model": art.get("model"),
        "calibrated_backend": art.get("backend"),
        "calibrated_unix": art.get("created_unix"),
        "measured_knee_rows": measured,
        "drift_frac": _rnd(drift_frac, 4),
        "drift": drift,
        "note": ("no live decode compositions to compare against — "
                 "feed --trace-dir or a bench artifact"
                 if measured is None else
                 (f"knee moved {drift_frac:.0%} from calibration "
                  "(>= 25%): re-run tools/autotune.py and re-resolve "
                  "--serve-batch auto" if drift else None)),
    }


def serve_batch_recommendation(knee: dict | None,
                               hbm: dict | None) -> dict | None:
    """The knee, capped by what HBM can actually hold: current batch
    rows + ``slots_addable`` from the hbm block (when a backend
    reported a limit — CPU artifacts carry null headroom and the knee
    stands alone)."""
    if knee is None:
        return None
    rec = int(knee["knee_rows"])
    cap = None
    if hbm and hbm.get("slots_addable") is not None:
        cur = max((r["rows"] for r in knee["curve"]), default=rec)
        cap = cur + int(hbm["slots_addable"])
        rec = min(rec, cap)
    return {"serve_batch": rec, "hbm_cap_rows": cap,
            "basis": knee["method"]}


def goodput(paths: list[dict], events: list[dict], *, slo_ttft_ms: float,
            slo_itl_ms: float) -> dict:
    done = [p for p in paths
            if not str(p["status"]).startswith("error")]
    ok = [p for p in done
          if (p.get("ttft_ms") is not None
              and p["ttft_ms"] <= slo_ttft_ms
              and (p.get("itl_ms") is None or p["itl_ms"] <= slo_itl_ms))]
    ts = [e.get("ts_wall", e.get("ts")) for e in events
          if e.get("ts_wall") is not None or e.get("ts") is not None]
    window_s = (max(ts) - min(ts)) if len(ts) > 1 else None
    tok_ok = sum(p.get("n_out") or 0 for p in ok)
    tok_all = sum(p.get("n_out") or 0 for p in done)
    return {
        "slo_ttft_ms": slo_ttft_ms,
        "slo_itl_ms": slo_itl_ms,
        "completed": len(done),
        "within_slo": len(ok),
        "slo_fraction": _rnd(len(ok) / len(done), 4) if done else None,
        "window_s": _rnd(window_s),
        "goodput_tok_s": _rnd(tok_ok / window_s, 2) if window_s else None,
        "throughput_tok_s": _rnd(tok_all / window_s, 2)
        if window_s else None,
    }


def tail_attribution(paths: list[dict], k: int = 5) -> list[dict]:
    """The k slowest requests, each naming the phase that ate its
    budget — a p99 regression debugging session starts here, not at an
    aggregate percentile."""
    ranked = sorted((p for p in paths if p.get("total_ms") is not None),
                    key=lambda p: -p["total_ms"])
    out = []
    for p in ranked[:k]:
        total = p["total_ms"] or 1.0
        shares = {ph: _rnd((p.get(f"{ph}_ms") or 0.0) / total, 3)
                  for ph in ("queue", "prefill", "decode")}
        out.append({**p, "phase_shares": shares})
    return out


# -- the wire report (measured cluster-plane traffic) ----------------------

# runtime/netstats.WIRE_DRIFT_FRAC, repeated: this tool imports nothing of
# the package
WIRE_DRIFT_FRAC = 0.25


def wire_report(events: list[dict], bench_rows: list[dict]) -> dict | None:
    """The comms section (the repo's tools/dlprof.py wire_report):
    per-peer measured bytes/frames and RTT tails from the rows' ``wire``
    blocks, the KV block transfer record from their ``kv_transfer``
    blocks (a /stats dump of a replica tier, runtime/kv_transfer.py), the
    sampled device sync-vs-compute share from ``sync`` trace events, and
    every measured-vs-modeled reconciliation found, drift re-flagged at
    >= 25%. None when no input carries wire data."""
    peers: dict[str, dict] = {}
    reconciles: list[dict] = []

    def eat_summary(side: str, w: dict) -> None:
        for peer, rec in (w.get("peers") or {}).items():
            key = f"{side}:peer{peer}" if side else f"peer{peer}"
            out = peers.setdefault(key, {"tx_bytes": 0, "rx_bytes": 0,
                                         "tx_frames": 0, "rx_frames": 0,
                                         "by_kind": {}})
            for dirn in ("tx", "rx"):
                for kind, kb in (rec.get(dirn) or {}).items():
                    out[f"{dirn}_bytes"] += kb.get("bytes", 0)
                    out[f"{dirn}_frames"] += kb.get("frames", 0)
                    out["by_kind"][f"{dirn}:{kind}"] = {
                        "frames": kb.get("frames"),
                        "bytes": kb.get("bytes")}
            rtt = rec.get("rtt_ms")
            if rtt:
                out["rtt_ms"] = {k: rtt.get(k)
                                 for k in ("n", "p50_ms", "p99_ms",
                                           "mean_ms")}
            if rec.get("clock_offset_ms") is not None:
                out["clock_offset_ms"] = rec["clock_offset_ms"]

    kvx_blocks: list[dict] = []
    for row in bench_rows:
        w = row.get("wire")
        if isinstance(w, dict) and w:
            if "peers" in w:  # a raw WireStats summary
                eat_summary("", w)
            else:             # {"root": summary, "worker": summary, ...}
                for side, sub in w.items():
                    if isinstance(sub, dict) and "peers" in sub:
                        eat_summary(side, sub)
            if isinstance(w.get("reconcile"), dict):
                # COPY: the drift flag is re-derived below, and the
                # report must never mutate the caller's loaded rows
                reconciles.append(dict(w["reconcile"]))
        # KV block transfer blocks (runtime/kv_transfer.py): a bench
        # row's (or /stats dump's) kv_transfer summary, incl. its own
        # measured-vs-modeled reconcile entry
        kvx = row.get("kv_transfer")
        if isinstance(kvx, dict) and kvx:
            kvx_blocks.append(kvx)
            if isinstance(kvx.get("reconcile"), dict):
                reconciles.append(dict(kvx["reconcile"]))
            sub = kvx.get("wire")
            if isinstance(sub, dict) and "peers" in sub:
                eat_summary("kvx", sub)

    syncs = [e for e in events if e.get("kind") == "sync"]
    sync = None
    if syncs:
        sync_ms = [float(e.get("sync_ms") or 0.0) for e in syncs]
        dev_ms = [float(e.get("device_ms") or 0.0) for e in syncs]
        total_dev = sum(dev_ms)
        sync = {
            "sampled_steps": len(syncs),
            "sync_p50_ms": _rnd(percentile(sync_ms, 50), 4),
            "sync_p99_ms": _rnd(percentile(sync_ms, 99), 4),
            "device_p50_ms": _rnd(percentile(dev_ms, 50), 4),
            # window sums, not mean-of-ratios (an idle step's ratio must
            # not swamp the loaded steps) — same rule as SyncStats
            "sync_share": (_rnd(sum(sync_ms) / total_dev, 4)
                           if total_dev else None),
        }

    kvx = None
    if kvx_blocks:
        # sum the counters across blocks (a disaggregated bench row may
        # carry one block per party); transfer tails only report when
        # exactly one block has them (percentiles do not merge)
        keys = ("fills_requested", "fills_ok", "fill_fallbacks",
                "fill_misses", "tokens_filled", "blocks_filled",
                "bytes_rx", "bytes_tx", "blocks_exported",
                "queries_served", "query_misses", "prefill_passes",
                "prefill_pass_fallbacks", "shadow_truncates")
        kvx = {k: sum(int(b.get(k) or 0) for b in kvx_blocks)
               for k in keys}
        with_ms = [b for b in kvx_blocks
                   if b.get("transfer_p50_ms") is not None]
        kvx["transfer_p50_ms"] = (with_ms[0]["transfer_p50_ms"]
                                  if len(with_ms) == 1 else None)
        kvx["transfer_p99_ms"] = (with_ms[0].get("transfer_p99_ms")
                                  if len(with_ms) == 1 else None)
        req = kvx["fills_requested"]
        kvx["fill_hit_rate"] = (_rnd(kvx["fills_ok"] / req, 4)
                                if req else None)

    if not peers and sync is None and not reconciles and kvx is None:
        return None
    # re-derive the drift flag locally: committed artifacts may predate
    # the producer's threshold, and the report must flag consistently
    for rec in reconciles:
        if rec.get("drift_frac") is not None:
            rec["drift"] = rec["drift_frac"] >= WIRE_DRIFT_FRAC
    return {"peers": peers, "sync": sync, "kv_transfer": kvx,
            "reconcile": reconciles,
            "drift": any(r.get("drift") for r in reconciles)}


# -- the report -------------------------------------------------------------


def analyze(events: list[dict], bench_rows: list[dict] | None = None, *,
            slo_ttft_ms: float = 500.0, slo_itl_ms: float = 100.0,
            autotune: dict | None = None, wire: bool = False) -> dict:
    bench_rows = bench_rows or []
    timeline = merge_timelines(events, bench_rows)
    paths = [p for p in (critical_path(s)
                         for s in spans_from_events(events).values())
             if p is not None]
    curve = decode_curve(timeline)
    knee = knee_estimate(curve)
    hbm = next((r["hbm"] for r in bench_rows
                if isinstance(r.get("hbm"), dict) and r["hbm"]), None)
    report = {
        "inputs": {"events": len(events), "spans": len(paths),
                   "bench_rows": len(bench_rows),
                   "compositions": len(timeline)},
        "requests": request_summary(paths),
        "critical_paths": paths,
        "step_curve": {
            "compositions": {f"dec{k[0]}_pre{k[1]}_c{k[2]}": v
                             for k, v in sorted(timeline.items())},
            "decode_points": [{"rows": b, "p50_ms": ms}
                              for b, ms in curve],
            "knee": knee,
            "recommendation": serve_batch_recommendation(knee, hbm),
        },
        "goodput": goodput(paths, events, slo_ttft_ms=slo_ttft_ms,
                           slo_itl_ms=slo_itl_ms),
        "tail": tail_attribution(paths),
        "hbm": hbm,
    }
    if autotune is not None:
        report["autotune"] = autotune_comparison(knee, autotune)
    if wire:
        report["wire"] = wire_report(events, bench_rows)
    return report


def render_markdown(report: dict) -> str:
    lines = ["# dlprof report", ""]
    inp = report["inputs"]
    lines += [f"Inputs: {inp['events']} events, {inp['spans']} spans, "
              f"{inp['bench_rows']} bench rows, "
              f"{inp['compositions']} step compositions.", ""]

    r = report["requests"]
    lines += ["## Requests", "",
              f"{r['requests']} analyzed — {r['completed']} completed, "
              f"{r['errors']} errors, {r['retried']} retried.", "",
              "| phase | p50 ms | p99 ms | n |", "|---|---|---|---|"]
    for ph in ("queue_ms", "prefill_ms", "ttft_ms", "itl_ms",
               "decode_ms", "total_ms"):
        row = r[ph]
        lines.append(f"| {ph.removesuffix('_ms')} | {row['p50']} | "
                     f"{row['p99']} | {row['n']} |")
    lines.append("")

    sc = report["step_curve"]
    lines += ["## Batch-composition → ms/step", "",
              "| rows | p50 ms | rows/s |", "|---|---|---|"]
    knee = sc["knee"]
    for p in (knee or {}).get("curve", []) or [
            {"rows": q["rows"], "p50_ms": q["p50_ms"], "rows_per_s": None}
            for q in sc["decode_points"]]:
        lines.append(f"| {p['rows']} | {p['p50_ms']} | "
                     f"{p.get('rows_per_s')} |")
    if knee:
        lines += ["", f"**Knee: {knee['knee_rows']} rows** "
                      f"({knee['method']})."]
        if knee.get("note"):
            lines.append(f"_{knee['note']}_")
    rec = sc["recommendation"]
    if rec:
        cap = (f" (HBM caps at {rec['hbm_cap_rows']})"
               if rec.get("hbm_cap_rows") is not None else "")
        lines += ["", f"**Recommended `--serve-batch "
                      f"{rec['serve_batch']}`**{cap}."]
    lines.append("")

    at = report.get("autotune")
    if at:
        lines += ["## Calibration drift (AUTOTUNE.json)", "",
                  f"Calibrated knee {at['calibrated_knee_rows']} rows "
                  f"({at['calibrated_model']}/{at['calibrated_backend']})"
                  f" vs measured {at['measured_knee_rows']} — drift "
                  f"{at['drift_frac']}"
                  + (" ⚠️ **DRIFTED**" if at["drift"] else " (ok)")
                  + ".", ""]
        if at.get("note"):
            lines += [f"_{at['note']}_", ""]

    g = report["goodput"]
    lines += ["## Goodput", "",
              f"{g['within_slo']}/{g['completed']} requests within "
              f"TTFT ≤ {g['slo_ttft_ms']} ms ∧ ITL ≤ {g['slo_itl_ms']} ms"
              + (f" — {g['goodput_tok_s']} tok/s goodput of "
                 f"{g['throughput_tok_s']} tok/s total"
                 if g.get("goodput_tok_s") is not None else "") + ".", ""]

    if report["tail"]:
        lines += ["## Tail attribution", "",
                  "| tid | total ms | status | dominant phase | "
                  "queue/prefill/decode share |", "|---|---|---|---|---|"]
        for t in report["tail"]:
            sh = t["phase_shares"]
            lines.append(
                f"| {t['tid']} | {t['total_ms']} | {t['status']} | "
                f"{t['dominant_phase']} | {sh['queue']}/{sh['prefill']}/"
                f"{sh['decode']} |")
        lines.append("")

    w = report.get("wire")
    if w:
        lines += ["## Wire (measured cluster plane)", ""]
        if w["peers"]:
            lines += ["| peer | tx bytes | rx bytes | frames (tx/rx) | "
                      "rtt p50/p99 ms | clock offset ms |",
                      "|---|---|---|---|---|---|"]
            for name, rec in sorted(w["peers"].items()):
                rtt = rec.get("rtt_ms") or {}
                lines.append(
                    f"| {name} | {rec['tx_bytes']} | {rec['rx_bytes']} | "
                    f"{rec['tx_frames']}/{rec['rx_frames']} | "
                    f"{rtt.get('p50_ms')}/{rtt.get('p99_ms')} | "
                    f"{rec.get('clock_offset_ms')} |")
            lines.append("")
        sync = w.get("sync")
        if sync:
            lines += [f"Sync vs compute (sampled device steps, "
                      f"n={sync['sampled_steps']}): collective p50 "
                      f"{sync['sync_p50_ms']} ms of device p50 "
                      f"{sync['device_p50_ms']} ms — **share "
                      f"{sync['sync_share']}**.", ""]
        kvx = w.get("kv_transfer")
        if kvx:
            lines += ["### KV transfer", "",
                      f"Fills: {kvx['fills_ok']}/"
                      f"{kvx['fills_requested']} ok "
                      f"(hit rate {kvx.get('fill_hit_rate')}), "
                      f"{kvx['fill_fallbacks']} degraded to re-prefill, "
                      f"{kvx['fill_misses']} donor misses.",
                      f"Moved: {kvx['tokens_filled']} tokens / "
                      f"{kvx['blocks_filled']} blocks "
                      f"({kvx['bytes_rx']} B rx, {kvx['bytes_tx']} B "
                      f"tx); transfer p50/p99 "
                      f"{kvx.get('transfer_p50_ms')}/"
                      f"{kvx.get('transfer_p99_ms')} ms.",
                      f"Disaggregation: {kvx['prefill_passes']} prefill "
                      f"passes, {kvx['prefill_pass_fallbacks']} mixed-"
                      f"path fallbacks; {kvx['shadow_truncates']} stale "
                      f"shadow paths cleared.", ""]
        for rec in w.get("reconcile") or ():
            flag = " ⚠️ **DRIFTED**" if rec.get("drift") else " (ok)"
            lines.append(
                f"Measured vs modeled ({rec.get('unit', 'bytes')}): "
                f"{rec.get('measured')} vs {rec.get('modeled')} — drift "
                f"{rec.get('drift_frac')}{flag}.")
            if rec.get("note"):
                lines.append(f"_{rec['note']}_")
        if w.get("reconcile"):
            lines.append("")

    hbm = report.get("hbm")
    if hbm:
        lines += ["## HBM ledger (from bench row)", "",
                  "| category | bytes |", "|---|---|"]
        for k in ("weights_bytes", "vocab_bytes", "kv_slot_bytes",
                  "prefix_arena_bytes", "logits_workspace_bytes",
                  "headroom_bytes"):
            lines.append(f"| {k.removesuffix('_bytes')} | {hbm.get(k)} |")
        if hbm.get("slots_addable") is not None:
            lines.append(f"| slots_addable | {hbm['slots_addable']} |")
        lines.append("")
    return "\n".join(lines)


# -- selftest ----------------------------------------------------------------


def _selftest() -> int:
    """Synthesize a tiny trace + step_timeline and assert the report
    parses with a non-null knee (fast, stdlib only)."""
    import tempfile

    events = []
    t = 1000.0
    for tid in (1, 2, 3):
        t += 0.010
        events.append({"ts_wall": t, "kind": "enqueue", "tid": tid,
                       "n_prompt": 9, "max_tokens": 6})
        t += 0.004
        events.append({"ts_wall": t, "kind": "admit", "tid": tid,
                       "slot": 0, "queue_ms": 4.0})
        events.append({"ts_wall": t, "kind": "seed", "tid": tid,
                       "hit": 0 if tid == 1 else 8, "n_prompt": 9})
        t += 0.020
        events.append({"ts_wall": t, "kind": "first_token", "tid": tid,
                       "ttft_ms": 24.0})
        t += 0.050
        events.append({"ts_wall": t, "kind": "finish", "tid": tid,
                       "reason": "length", "n_out": 6})
    # a decode curve with a visible knee at 4 rows
    for rows, ms in ((1, 5.0), (2, 5.4), (4, 6.2), (8, 14.0)):
        for _ in range(8):
            events.append({"ts_wall": t, "kind": "step", "tid": 0,
                           "dec": rows, "pre": 0, "chunk": 0,
                           "queue": 0, "ms": ms})
    bench_row = {"metric": "selftest", "step_timeline": {
        "dec8_pre0_c0": {"n": 64, "p50_ms": 14.0, "p99_ms": 15.0,
                         "mean_ms": 14.1}},
        "hbm": {"weights_bytes": 1 << 20, "kv_slot_bytes": 1 << 18,
                "prefix_arena_bytes": 1 << 18,
                "logits_workspace_bytes": 1 << 16,
                "slots_addable": None}}
    # round-trip through a real trace dir: the loader is part of the smoke
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "trace-00000001.jsonl"), "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        report = analyze(load_trace_dir(d), [bench_row])
    assert report["requests"]["requests"] == 3, report["requests"]
    assert report["requests"]["completed"] == 3
    knee = report["step_curve"]["knee"]
    assert knee is not None and knee["knee_rows"] == 4, knee
    assert report["step_curve"]["recommendation"]["serve_batch"] == 4
    assert report["goodput"]["completed"] == 3
    assert report["tail"], "tail attribution empty"
    json.dumps(report)                      # JSON-clean
    md = render_markdown(report)
    assert "Knee: 4 rows" in md, md

    # the AUTOTUNE.json input path: a matching calibration reads clean, a
    # knee that moved 2x flags drift in the report AND the markdown
    art = {"kind": AUTOTUNE_KIND, "version": AUTOTUNE_VERSION,
           "model": "selftest", "backend": "none", "created_unix": 0.0,
           "decode_curve": [],
           "knee": {"knee_rows": 4, "method": "marginal_throughput"}}
    assert not validate_autotune(art), validate_autotune(art)
    assert validate_autotune({"kind": "bogus"})  # bad artifact named
    with tempfile.TemporaryDirectory() as d:
        ap = os.path.join(d, "AUTOTUNE.json")
        with open(ap, "w") as f:
            json.dump(art, f)
        with open(os.path.join(d, "trace-00000001.jsonl"), "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        r2 = analyze(load_trace_dir(d), [bench_row],
                     autotune=load_autotune(ap))
    at = r2["autotune"]
    assert at["measured_knee_rows"] == 4 and not at["drift"], at
    drifted = autotune_comparison({"knee_rows": 8},
                                  dict(art, knee={"knee_rows": 4}))
    assert drifted["drift"] and drifted["drift_frac"] == 1.0, drifted
    assert "Calibration drift" in render_markdown(r2)

    # the wire section: a row's measured cluster ledger and sampled sync
    # events give the per-peer table, the sync share and the
    # reconciliation; an exact match reads clean, a 30%-off model flags
    wire_row = {"metric": "wire-selftest", "wire": {
        "root": {"peers": {"1": {
            "tx": {"PING": {"frames": 5, "bytes": 120},
                   "RUN": {"frames": 2, "bytes": 223}},
            "rx": {"PONG": {"frames": 5, "bytes": 160}},
            "rtt_ms": {"n": 5, "p50_ms": 0.9, "p99_ms": 1.7,
                       "mean_ms": 1.1},
            "clock_offset_ms": 0.07}}},
        "reconcile": {"measured": 223.0, "modeled": 223.0,
                      "unit": "bytes", "drift_frac": 0.0,
                      "drift": False}}}
    sync_events = [{"ts_wall": t, "kind": "sync", "tid": 0,
                    "sync_ms": 2.0, "device_ms": 8.0, "share": 0.25}
                   for _ in range(4)]
    rw = analyze(events + sync_events, [bench_row, wire_row], wire=True)
    w = rw["wire"]
    assert w is not None and not w["drift"], w
    assert w["peers"]["root:peer1"]["tx_bytes"] == 343, w["peers"]
    assert w["sync"]["sync_share"] == 0.25, w["sync"]
    md_w = render_markdown(rw)
    assert "Wire (measured cluster plane)" in md_w and "0.25" in md_w
    drifted_row = {"metric": "w2", "wire": {
        "reconcile": {"measured": 130.0, "modeled": 100.0,
                      "unit": "bytes", "drift_frac": 0.3, "drift": True}}}
    wd = analyze(events, [drifted_row], wire=True)["wire"]
    assert wd["drift"] and wd["reconcile"][0]["drift"], wd
    assert "DRIFTED" in render_markdown({**rw, "wire": wd})
    # without --wire the report is unchanged (no section, no key)
    assert "wire" not in analyze(events, [wire_row]), "wire leaked"

    # the KV transfer section (runtime/kv_transfer.py): a bench row's
    # kv_transfer block -> fills/bytes/disagg lines + its reconcile
    # entry folded into the wire report (exact reads clean; drift flags)
    kvx_row = {"metric": "kvx-selftest", "kv_transfer": {
        "enabled": True, "tier": "aggregate",
        "fills_requested": 4, "fills_ok": 3, "fill_fallbacks": 1,
        "fill_misses": 1, "tokens_filled": 96, "blocks_filled": 6,
        "bytes_rx": 6144, "bytes_tx": 6144, "blocks_exported": 6,
        "queries_served": 4, "query_misses": 1, "prefill_passes": 2,
        "prefill_pass_fallbacks": 1, "shadow_truncates": 1,
        "transfer_p50_ms": 2.5, "transfer_p99_ms": 4.0,
        "reconcile": {"measured": 6144.0, "modeled": 6144.0,
                      "unit": "bytes", "drift_frac": 0.0,
                      "drift": False}}}
    rk = analyze(events, [kvx_row], wire=True)["wire"]
    assert rk is not None and rk["kv_transfer"] is not None, rk
    assert rk["kv_transfer"]["fills_ok"] == 3, rk["kv_transfer"]
    assert rk["kv_transfer"]["fill_hit_rate"] == 0.75
    assert rk["kv_transfer"]["transfer_p50_ms"] == 2.5
    assert not rk["drift"], rk
    md_k = render_markdown({**rw, "wire": rk})
    assert "KV transfer" in md_k and "3/4 ok" in md_k, md_k
    kvx_drift = {"metric": "kvx2", "kv_transfer": {
        "fills_requested": 1, "fills_ok": 1, "fill_fallbacks": 0,
        "fill_misses": 0, "tokens_filled": 16, "blocks_filled": 1,
        "bytes_rx": 1300, "bytes_tx": 1300, "blocks_exported": 1,
        "queries_served": 1, "query_misses": 0, "prefill_passes": 0,
        "prefill_pass_fallbacks": 0, "shadow_truncates": 0,
        "reconcile": {"measured": 1300.0, "modeled": 1000.0,
                      "unit": "bytes", "drift_frac": 0.3,
                      "drift": True}}}
    rkd = analyze(events, [kvx_drift], wire=True)["wire"]
    assert rkd["drift"], rkd

    print("dlprof selftest: OK (knee=4, 3 spans, autotune drift check, "
          "wire section + sync share + drift flag, KV transfer section, "
          "report renders)")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dlprof", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace-dir", default=None,
                    help="server --trace-dir (rotating JSONL; worker "
                         "subdirs included)")
    ap.add_argument("--bench", action="append", default=[],
                    help="bench.py artifact JSON (repeatable)")
    ap.add_argument("--autotune", default=None, metavar="FILE",
                    help="AUTOTUNE.json calibration artifact "
                         "(python -m distributed_llama_tpu_torch.tools.autotune): the report compares its "
                         "calibrated knee against the live measured one "
                         "and flags >= 25%% drift")
    ap.add_argument("--wire", action="store_true",
                    help="add the measured cluster-plane comms section: "
                         "per-peer bytes + RTT tails from the rows' "
                         "`wire` blocks, device sync-vs-compute share "
                         "from sampled `sync` trace events, and every "
                         "measured-vs-modeled reconciliation (drift "
                         "flagged at >= 25%%)")
    ap.add_argument("--slo-ttft-ms", type=float, default=500.0)
    ap.add_argument("--slo-itl-ms", type=float, default=100.0)
    ap.add_argument("--out", default=None, metavar="PREFIX",
                    help="write PREFIX.json + PREFIX.md (default: JSON "
                         "to stdout)")
    ap.add_argument("--selftest", action="store_true",
                    help="synthesize inputs, assert the report parses "
                         "with a non-null knee")
    args = ap.parse_args(argv)
    if args.selftest:
        return _selftest()
    if not args.trace_dir and not args.bench:
        ap.error("need --trace-dir and/or --bench (or --selftest)")
    events = load_trace_dir(args.trace_dir) if args.trace_dir else []
    rows: list[dict] = []
    for b in args.bench:
        rows += load_bench(b)
    art = None
    if args.autotune:
        try:
            art = load_autotune(args.autotune)
        except (OSError, ValueError) as e:
            ap.error(f"--autotune {args.autotune}: {e}")
    report = analyze(events, rows, slo_ttft_ms=args.slo_ttft_ms,
                     slo_itl_ms=args.slo_itl_ms, autotune=art,
                     wire=args.wire)
    at = report.get("autotune")
    if at and at["drift"]:
        print(f"dlprof: ⚠️ knee drift {at['drift_frac']:.0%} — calibrated "
              f"{at['calibrated_knee_rows']} vs measured "
              f"{at['measured_knee_rows']} rows (re-run tools/autotune.py)",
              file=sys.stderr)
    w = report.get("wire")
    if w and w.get("drift"):
        print("dlprof: ⚠️ measured wire traffic drifted >= 25% from the "
              "model — see the report's wire.reconcile entries",
              file=sys.stderr)
    if args.out:
        with open(args.out + ".json", "w") as f:
            json.dump(report, f, indent=1)
        with open(args.out + ".md", "w") as f:
            f.write(render_markdown(report))
        print(f"dlprof: wrote {args.out}.json + {args.out}.md "
              f"({report['inputs']['spans']} spans, knee="
              f"{(report['step_curve']['knee'] or {}).get('knee_rows')})")
    else:
        json.dump(report, sys.stdout, indent=1)
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
