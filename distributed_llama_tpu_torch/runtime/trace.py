"""The /metrics plane — the port's copy of ``render_prometheus`` from the
JAX package's runtime/trace.py: the /stats summary dict as Prometheus text
exposition (GET /metrics, apps/api_server.py), for the families the
single-GPU serving stack produces, the radix prefix cache's included.

The flight recorder (``Tracer``: per-request spans, the step timeline and
its ``dllama_step_ms`` families) comes with the --trace flags that turn it
on (ROADMAP item 10c). The JSONL sink and the router, transfer, fleet and
cluster families are not ported.
"""

from __future__ import annotations

# -- Prometheus text exposition ---------------------------------------------

# /stats summary counters -> Prometheus counters
_COUNTERS = (
    ("requests_submitted", "dllama_requests_submitted_total",
     "Requests accepted at the serving door"),
    ("requests_finished", "dllama_requests_finished_total",
     "Requests that received a terminal event"),
    ("requests_failed", "dllama_requests_failed_total",
     "Requests failed with a structured error frame"),
    ("requests_expired", "dllama_requests_expired_total",
     "Requests killed by deadline or queue-time budget"),
    ("requests_rejected", "dllama_requests_rejected_total",
     "Requests refused at submit (queue bound)"),
    ("tokens_out", "dllama_tokens_out_total", "Tokens emitted"),
    ("steps", "dllama_scheduler_steps_total", "Scheduler iterations"),
)

_GAUGES = (
    ("ttft_p50_ms", "dllama_ttft_ms", {"quantile": "0.5"},
     "Time to first token, sliding window"),
    ("ttft_p99_ms", "dllama_ttft_ms", {"quantile": "0.99"}, None),
    ("itl_p50_ms", "dllama_itl_ms", {"quantile": "0.5"},
     "Inter-token latency, sliding window"),
    ("itl_p99_ms", "dllama_itl_ms", {"quantile": "0.99"}, None),
    ("mean_slot_occupancy", "dllama_slot_occupancy_mean", {},
     "Mean live slots per scheduler iteration (window)"),
    ("max_queue_depth", "dllama_queue_depth_max", {},
     "Max admission-queue depth (window)"),
)

_PREFIX = (
    ("lookups", "dllama_prefix_cache_lookups_total"),
    ("hits", "dllama_prefix_cache_hits_total"),
    ("tokens_saved", "dllama_prefix_cache_tokens_saved_total"),
    ("tokens_prefilled", "dllama_prefix_cache_tokens_prefilled_total"),
    ("blocks_published", "dllama_prefix_cache_blocks_published_total"),
    ("evictions", "dllama_prefix_cache_evictions_total"),
    ("publish_drops", "dllama_prefix_cache_publish_drops_total"),
)
# blocks_in_use is a level (it drops as blocks free or evict): a gauge,
# never a counter, which rate() would read as a reset at every drop
_PREFIX_GAUGES = (
    ("blocks_in_use", "dllama_prefix_cache_blocks_in_use"),
)

_RESILIENCE = (
    ("crashes", "dllama_supervisor_crashes_total"),
    ("watchdog_trips", "dllama_supervisor_watchdog_trips_total"),
    ("recoveries", "dllama_supervisor_recoveries_total"),
    ("rejected_unready", "dllama_supervisor_rejected_unready_total"),
)


def _esc(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


class _Prom:
    """Exposition-format builder: one # HELP/# TYPE header a name."""

    def __init__(self):
        self._meta: dict[str, tuple[str, str]] = {}
        self._samples: dict[str, list[str]] = {}

    def add(self, name: str, value, labels: dict | None = None,
            help_: str | None = None, type_: str = "gauge") -> None:
        if value is None:
            return
        if name not in self._meta:
            self._meta[name] = (help_ or name, type_)
            self._samples[name] = []
        lab = ""
        if labels:
            lab = "{" + ",".join(f'{k}="{_esc(v)}"'
                                 for k, v in labels.items()) + "}"
        self._samples[name].append(f"{name}{lab} {value}")

    def render(self) -> str:
        out = []
        for name, (help_, type_) in self._meta.items():
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {type_}")
            out.extend(self._samples[name])
        return "\n".join(out) + "\n"


def _add_block(p: _Prom, block: dict | None, table, *, type_: str) -> None:
    if not block:
        return
    for key, name in table:
        p.add(name, block.get(key), type_=type_)


_SPEC_COUNTERS = (
    ("verify_forwards", "spec_verify_forwards_total",
     "Fixed-width speculative verify forwards dispatched"),
    ("draft_forwards", "spec_draft_forwards_total",
     "Draft dispatches (one k-token scan or prefill chunk == one)"),
    ("drafted", "spec_drafted_tokens_total",
     "Draft tokens proposed to the verifier"),
    ("accepted", "spec_accepted_tokens_total",
     "Draft tokens the verify forward confirmed"),
    ("emitted_spec", "spec_emitted_tokens_total",
     "Tokens emitted by speculating rows"),
    ("degraded_steps", "spec_degraded_steps_total",
     "Iterations the SLO admission policy ran with drafting disabled"),
)


def _add_spec(p: _Prom, spec: dict | None, *, labels: dict | None = None,
              prefix: str = "dllama_") -> None:
    """The speculative-decoding family (the SpecStats summary), attached
    even with drafting off (mode "off", zeros), so the family never
    vanishes off a launch flag. `labels` and `prefix` serve a per-replica
    block (dllama_replica_spec_*), as the JAX renderer's do."""
    if not spec:
        return
    per = " (per replica)" if prefix != "dllama_" else ""
    p.add(f"{prefix}spec_mode", 1,
          {**(labels or {}), "mode": _esc(spec.get("mode", "off")),
           "draft_len": str(spec.get("draft_len", 0))},
          help_=f"Draft mode in effect (info-style: constant 1){per}")
    for key, name, help_ in _SPEC_COUNTERS:
        p.add(f"{prefix}{name}", spec.get(key), labels, type_="counter",
              help_=help_ + per)
    p.add(f"{prefix}spec_accept_rate", spec.get("accept_rate"), labels,
          help_="Accepted / drafted over the scheduler generation — the "
                "number that says whether speculation pays on this "
                f"traffic (docs/operations.md){per}")
    p.add(f"{prefix}spec_tokens_per_verify", spec.get("tokens_per_verify"),
          labels,
          help_=f"Mean tokens emitted per verify forward{per}")


def _add_device_blocks(p: _Prom, summary: dict) -> None:
    """The device-tier families (runtime/profiler.py): the ledger of
    captured graphs, the memory ledger, the sampled step device time."""
    pre = "dllama_"
    comp = summary.get("compiles")
    if comp:
        p.add(pre + "compiles_after_warmup_total",
              comp.get("after_warmup"), type_="counter",
              help_="Compiles minted after the serving set was warm "
                    "(the recompile sentinel)")
        for key, rec in (comp.get("by_key") or {}).items():
            lab = {"key": _esc(key)}
            p.add(pre + "compiles_total", rec.get("count"), lab,
                  type_="counter", help_="Executable mints by compile key")
            p.add(pre + "compile_ms", rec.get("ms"), lab,
                  type_="counter",
                  help_="Cumulative trace+compile wall ms by compile key")
    hbm = summary.get("hbm")
    if hbm:
        for cat, field in (("weights", "weights_bytes"),
                           ("vocab", "vocab_bytes"),
                           ("kv_slots", "kv_slot_bytes"),
                           ("prefix_arena", "prefix_arena_bytes"),
                           ("logits_workspace", "logits_workspace_bytes")):
            p.add(pre + "hbm_bytes", hbm.get(field), {"category": cat},
                  help_="Live HBM bytes by category (known array shapes)")
        p.add(pre + "hbm_device_bytes", hbm.get("device_bytes_in_use"),
              {"kind": "in_use"},
              help_="Backend allocator stats, where provided")
        p.add(pre + "hbm_device_bytes", hbm.get("device_bytes_limit"),
              {"kind": "limit"})
        p.add(pre + "hbm_slots_addable", hbm.get("slots_addable"),
              help_="KV slots that still fit free HBM (headroom)")
        p.add(pre + "hbm_prefix_blocks_addable",
              hbm.get("prefix_blocks_addable"),
              help_="Prefix-arena blocks that still fit free HBM")
    dev = summary.get("device_time")
    if dev:
        p.add(pre + "profile_sampled_steps_total",
              dev.get("sampled_steps"), type_="counter",
              help_="Scheduler steps captured for device-time attribution")
        for entry, rec in (dev.get("by_entry") or {}).items():
            lab = {"entry": _esc(entry)}
            p.add(pre + "device_ms", rec.get("p50_ms"),
                  {**lab, "quantile": "0.5"},
                  help_="Sampled per-step device ms by entry point")
            p.add(pre + "device_samples_total", rec.get("n"), lab,
                  type_="counter")


def render_prometheus(summary: dict | None, *, model: str = "dllama",
                      mode: str = "scheduler",
                      state: str | None = None,
                      build: dict | None = None) -> str:
    """The GET /metrics body: the /stats summary dict (None while the
    legacy mode) as Prometheus text exposition format."""
    p = _Prom()
    p.add("dllama_up", 1, {"model": model, "mode": mode},
          help_="The serving process is up", type_="gauge")
    if build:
        p.add("dllama_build_info", 1,
              {k: _esc(v) for k, v in build.items()},
              help_="Build identity (constant 1; info in the labels)")
    states = ("ready", "recovering", "broken", "draining", "closed", "off")
    st = state or (summary or {}).get("state")
    if st is not None:
        for s in states:
            p.add("dllama_state", int(st == s), {"state": _esc(s)},
                  help_="Serving front-door state (one-hot)")
        if st not in states:
            p.add("dllama_state", 1, {"state": _esc(st)})
    if summary:
        for key, name, help_ in _COUNTERS:
            p.add(name, summary.get(key), help_=help_, type_="counter")
        for key, name, labels, help_ in _GAUGES:
            p.add(name, summary.get(key), labels=labels, help_=help_)
        _add_block(p, summary.get("prefix_cache"), _PREFIX, type_="counter")
        _add_block(p, summary.get("prefix_cache"), _PREFIX_GAUGES,
                   type_="gauge")
        _add_block(p, summary.get("resilience"), _RESILIENCE,
                   type_="counter")
        res = summary.get("resilience") or {}
        p.add("dllama_supervisor_recovery_ms", res.get("recovery_p50_ms"),
              {"quantile": "0.5"},
              help_="Failure-detected to ready-again latency")
        p.add("dllama_supervisor_recovery_ms", res.get("recovery_p99_ms"),
              {"quantile": "0.99"})
        _add_spec(p, summary.get("spec"))
        _add_device_blocks(p, summary)
    return p.render()
