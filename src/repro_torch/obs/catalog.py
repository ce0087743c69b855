"""Canonical help strings for every instrumented metric (DESIGN.md §13-§14).

``Instrumentation.count/gauge/observe`` look names up here so the Prometheus
exposition carries a real ``# HELP`` line for every metric the serving and
control layers emit. Keeping the catalog in one module (instead of help
kwargs scattered over call sites) makes "no metric without help" a single
registry-wide test (``tests/test_torch_obs.py``) rather than a per-call-site
convention.

A name missing from the catalog still registers (with empty help) — the
test, not the runtime, is the enforcement point.
"""

from __future__ import annotations

METRIC_HELP: dict[str, str] = {
    # ------------------------------------------------------- engine / batch
    "engine_queries": "Queries traversed by the host Engine, by exit reason.",
    "engine_postings": "Postings scored per host Engine traversal.",
    "batch_engine_chunk_lanes": "Live lanes per padded BatchEngine chunk.",
    "batch_engine_queries": "Queries served by BatchEngine, by exit reason.",
    # ------------------------------------------------------------ budgeter
    "budgeter_alpha": "Reactive SLA policy alpha (Eq. 7 feedback state).",
    "budgeter_cap_postings": "Latest postings budget cap issued per query.",
    "budgeter_feedback_ms": "Batch latencies fed back into the SLA policy.",
    "budgeter_rate": "EWMA postings/ms service rate (JASS time proxy).",
    "budgeter_shard_cap": "Per-shard postings budget cap, by shard.",
    "budgeter_shard_rate": "Per-shard EWMA postings/ms rate, by shard.",
    # ------------------------------------------------------------- servers
    "submitted": "Queries submitted to a server, by server label.",
    "admissions": "Queries admitted into in-flight slots.",
    "parks": "Queries parked while all in-flight slots were busy.",
    "budget_postings": "Finite admission postings budgets (sentinel-free).",
    "unlimited_admissions": "Admissions with an unlimited (inf-SLA) budget.",
    "batch_size": "Queries per drained micro-batch.",
    "batch_ms": "Wall-clock per micro-batch dispatch.",
    "step_ms": "Wall-clock per in-flight quantum step.",
    "active_lanes": "Live lanes per in-flight step.",
    "slot_occupancy": "Occupied in-flight slots after the latest step.",
    "queue_depth": "Queries waiting in the server queue, by server.",
    "served_queries": "Completed queries, by server and exit reason.",
    "latency_ms": "End-to-end query latency (submit to serve), by server.",
    "quanta": "Resume quanta a query lived through before completing.",
    # ------------------------------------------------------------- sharded
    "sharded_queries": "Queries served through the sharded broker.",
    "shard_exits": "Per-shard exit reasons across sharded queries.",
    "sharded_exact": "Sharded results by exactness certificate (§9).",
    "fidelity_bound": "Score-gap fidelity bounds on inexact results.",
    # ------------------------------------------------------- control plane
    "replica_dispatches": "Batches dispatched to a replica group.",
    "replica_pad_lanes": "Padding lanes added to fill a replica dispatch.",
    "health_transitions": "HealthLedger up/down transitions, by shard.",
    "reshard_started": "Online reshard tasks opened.",
    "reshard_cutovers": "Reshard cutovers committed onto the plane.",
    "reshard_ms": "Wall-clock from reshard start to cutover.",
    "shard_postings": "Postings scored per shard (control-plane observed).",
    "plane_available": "1 when every shard is up, else 0 (HealthLedger).",
    "plane_degraded_slo": "1 while a sustained SLO burn alert is firing.",
    # ------------------------------------------------------------ profiler
    "profiler_dispatches": "Profiled device dispatches, by site.",
    "profiler_compiles": "Dispatches that grew the launcher's program count "
    "on a new shape.",
    "profiler_recompiles": "Anomalies: the launcher's program count grew on "
    "an already-seen shape.",
    "profiler_plan_ms": "Host planning/staging time per dispatch, by site.",
    "profiler_dispatch_ms": "Host time to issue the device step (includes "
    "the kernel build when a compile happens).",
    "profiler_device_ms": "Device execution wait per dispatch "
    "(block_until_ready).",
    "profiler_transfer_ms": "Device-to-host result transfer per dispatch.",
    "hbm_bytes": "Live HBM bytes per device index array, by site and array.",
    "hbm_total_bytes": "Total live HBM bytes of the device index, by site.",
    # ----------------------------------------------------------------- slo
    "slo_attainment": "Windowed good/total attainment per SLO (3d window).",
    "slo_burn_rate": "Error-budget burn rate per SLO and window.",
    "slo_error_budget_remaining": "Fraction of the error budget left in the "
    "longest window.",
    "slo_state": "SLO alert state: 0 ok, 1 slow burn, 2 fast burn.",
    # -------------------------------------------------------------- detect
    "alerts": "Drift-detector alert events, by detector and state.",
}


def help_for(name: str) -> str:
    """Catalog lookup; empty string for uncataloged names."""
    return METRIC_HELP.get(name, "")
