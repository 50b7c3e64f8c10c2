"""The metric-name catalog (port of ``paddle_tpu/observability/catalog.py``):
every metric the port emits at runtime, declared once (name, type,
labels, unit, help).

The default registry refuses undeclared names at fetch time, and
``tests/test_torch_observability.py`` drives every instrumented
subsystem and asserts the emitted set equals this catalog, both ways: a
dashboard never chases a name that exists only in source code, and an
entry never outlives its instrumentation.  Each entry is the JAX
package's entry of the same name, word for word.

Only the names the port emits are here: the serving scheduler and
engine, the host KV tier, the disaggregated handoff, the router, the
HTTP front end, the faultpoints, the retry policy, the liveness monitor,
the cluster merge, the tensor-parallel overlap islands and the
checkpoint manager.  The JAX catalog's collective, training, autotune,
compile-watchdog and HBM-ledger names wait for their modules (ROADMAP.md
§A).

Naming: dotted ``<subsystem>.<what>_<unit>``; the Prometheus exporter
rewrites dots to underscores (``serving.ttft_seconds`` ->
``serving_ttft_seconds``).  Label value spaces are bounded by
construction (finish reasons, bucket sizes, status codes, declared
faultpoint sites and beacons).
"""
from __future__ import annotations

__all__ = ["CATALOG"]


def _m(type_, help_, labels=(), unit=""):
    return {"type": type_, "help": help_, "labels": tuple(labels),
            "unit": unit}


CATALOG = {
    # -- serving (engine + continuous-batching scheduler) -------------------
    "serving.ttft_seconds": _m(
        "histogram", "submit -> first token, per finished request "
        "(INCLUDES admission-queue wait; subtract serving.queue_wait_seconds "
        "for pure prefill latency)", unit="seconds"),
    "serving.queue_wait_seconds": _m(
        "histogram", "submit -> admission (prefill start), per request",
        unit="seconds"),
    "serving.tpot_seconds": _m(
        "histogram", "mean seconds per token after the first, per finished "
        "request", unit="seconds"),
    "serving.decode_step_seconds": _m(
        "histogram", "wall time of one batched decode iteration (all slots)",
        unit="seconds"),
    "serving.generated_tokens": _m(
        "counter", "decode tokens appended to live requests (prefill "
        "first-tokens excluded)"),
    "serving.prefill_bucket_hits": _m(
        "counter", "prefill admissions per power-of-two bucket",
        labels=("bucket",)),
    "serving.finished_requests": _m(
        "counter", "retired requests by finish reason",
        labels=("reason",)),
    "serving.slot_occupancy": _m(
        "gauge", "active slots after the latest scheduler iteration"),
    "serving.queue_depth": _m(
        "gauge", "requests waiting for admission"),
    "serving.tp_degree": _m(
        "gauge", "tensor-parallel degree of the most recently "
        "constructed decode engine (1 = single-chip; tp > 1 partitions "
        "the paged KV pool over heads on an ('mp',) mesh)"),
    "serving.page_pool_used": _m(
        "gauge", "KV pages currently mapped by any slot (paged cache "
        "occupancy; pool size is engine.num_pages)"),
    "serving.prefix_hit_pages": _m(
        "counter", "prompt pages served from the prefix hash cache at "
        "admission instead of being recomputed/stored"),
    "serving.cow_copies": _m(
        "counter", "copy-on-write page copies (a write targeted a page "
        "shared by another slot)"),
    "serving.prefill_chunk_seconds": _m(
        "histogram", "wall time of one chunked-prefill iteration (one "
        "fixed-size chunk of one admission, interleaved with decode)",
        unit="seconds"),
    "serving.preemptions": _m(
        "counter", "requests evicted under page-pool pressure and "
        "requeued for recompute (vLLM-style preemption; a request "
        "preempted past the scheduler's cap finishes 'cache_full' "
        "instead)"),
    "serving.spec_proposed_tokens": _m(
        "counter", "draft tokens proposed to the speculative verify "
        "step (spec_k per active slot per iteration; pair with "
        "serving.spec_accepted_tokens — accept rate = accepted / "
        "proposed)"),
    "serving.spec_accepted_tokens": _m(
        "counter", "draft tokens the speculative verify step accepted "
        "(the free extra tokens per iteration; the corrective/bonus "
        "sample is not counted)"),
    "serving.kv_quant_error": _m(
        "gauge", "max abs dequantization error of the latest decode/"
        "verify step's int8 KV appends (opt-in: "
        "PADDLE_TPU_METRICS_KV_QUANT_ERROR=1 at engine construction; "
        "forces one device sync per step)"),

    # -- tiered KV host cache (serving/kv_tier.py) --------------------------
    "serving.kv_host_bytes": _m(
        "gauge", "host-RAM page-tier occupancy of the most recent spill/"
        "invalidation (bounded by PADDLE_TPU_KV_HOST_BYTES; 0 = tier "
        "off or empty)", unit="bytes"),
    "serving.kv_host_misses": _m(
        "counter", "admissions whose prompt had uncovered pages at the "
        "device-coverage boundary and the host tier held none of them "
        "(counted once per admission attempt, not per poll)"),
    "serving.kv_host_spilled_pages": _m(
        "counter", "refcount-0 hash-reachable pages exported to the "
        "host tier (allocator reclaim spills + explicit cold-page "
        "spills)"),
    "serving.kv_host_hits": _m(
        "counter", "host-tier pages pulled back through kv_import and "
        "adopted device-side for an admission that missed the device "
        "prefix cache (a hit is a page that LANDED — torn fetches "
        "count nothing)"),
    "serving.kv_tier_fetch_seconds": _m(
        "histogram", "begin -> last page adopted of one host-tier "
        "fetch (interleaved between decode steps; the repeat-prompt "
        "TTFT includes this window)", unit="seconds"),

    # -- disaggregated prefill/decode (serving/disagg.py) -------------------
    "serving.handoff_bytes": _m(
        "counter", "KV bytes moved from a prefill engine's pool into a "
        "decode engine's pool by disaggregated page handoffs (K+V rows "
        "across all layers, int8 scale rows included — kv_row_bytes "
        "truth per transferred page)", unit="bytes"),
    "serving.handoff_seconds": _m(
        "histogram", "wall time of one handoff chunk (export -> stage "
        "-> import of up to handoff_pages pages), interleaved between "
        "decode steps", unit="seconds"),
    "serving.handoff_queue_depth": _m(
        "gauge", "requests queued for or mid KV handoff (the bounded "
        "handoff queue plus in-flight transfers)"),

    # -- replicated fleet (serving/router.py) -------------------------------
    "router.routed": _m(
        "counter", "admission routing decisions by ladder rung: "
        "affinity (prefix-digest view covered a non-empty prompt "
        "prefix), least_loaded (fresh-snapshot fallback, incl. the "
        "telemetry-blackout round-robin), failover (an orphaned "
        "in-flight request re-placed onto a survivor)",
        labels=("reason",)),
    "router.replicas_healthy": _m(
        "gauge", "replicas currently in the routable set (healthy — "
        "excludes dead, respawn-pending, and joining replicas still "
        "inside their healthy interval)"),
    "router.failovers": _m(
        "counter", "replica deaths the router failed over (crash at "
        "the serve.replica site, stalled step beacon past the "
        "deadline, or a dead thread) — each drains that replica's "
        "in-flight requests onto survivors via recompute requeue"),

    # -- serving front-end (serving/frontend.py) ----------------------------
    "serving.http_requests": _m(
        "counter", "HTTP requests by response status code (200 stream/"
        "complete, 400 bad request, 404, 429 shed over queue_limit, "
        "499 client disconnected mid-stream, 503 draining)",
        labels=("code",)),
    "serving.shed_total": _m(
        "counter", "requests shed by admission control (429 over the "
        "bounded queue + 503 while draining) — the load harness's shed "
        "rate numerator"),
    "serving.open_streams": _m(
        "gauge", "SSE streams currently open (connected clients being "
        "fed tokens)"),
    "serving.goodput_tokens": _m(
        "counter", "generated tokens actually DELIVERED to a connected "
        "client (streamed events that reached the socket, or the token "
        "array of a completed non-streaming response) — the goodput "
        "numerator; tokens computed for a disconnected/cancelled "
        "request never count"),

    # -- checkpoint (incubate/checkpoint) -----------------------------------
    "checkpoint.write_seconds": _m(
        "histogram", "full checkpoint save (serialize + shard write + "
        "manifest + publish)", unit="seconds"),
    "checkpoint.write_bytes": _m(
        "histogram", "bytes per checkpoint save (manifest-intended bytes)",
        unit="bytes"),
    "checkpoint.restore_seconds": _m(
        "histogram", "checkpoint restore (read + verify + deserialize)",
        unit="seconds"),

    # -- tensor-parallel collective-matmul overlap (distributed/mp_overlap)
    "mp.overlap_chunks": _m(
        "counter", "overlapped collective-matmul islands built at trace "
        "time, valued at the ring chunk count each resolved (the "
        "mp_overlap autotune family's knob; single-hop qkv re-deals "
        "count 1).  Trace-time like compile.count: a compile-once "
        "program contributes once, so a growing value under steady "
        "serving is a retrace leak"),

    # -- robustness (chaos faultpoints) -------------------------------------
    "robustness.faultpoint_fires": _m(
        "counter", "injected faults fired by the active FaultPlan",
        labels=("site",)),

    "robustness.retry_attempts": _m(
        "counter", "retries scheduled by retry_call (first attempts are "
        "not counted; exhaustion raises RetryError)", labels=("op",)),

    # -- liveness watchdog (observability.liveness — armed via
    # PADDLE_TPU_LIVENESS=1) --------------------------------------------------
    "liveness.stalls": _m(
        "counter", "stalls the liveness monitor fired: a declared "
        "progress beacon with work inflight made no progress past its "
        "deadline (each fire also produced an all-thread-stack flight "
        "dump; label space bounded by the declared beacon registry)",
        labels=("beacon",)),
    "liveness.straggler": _m(
        "gauge", "per-host straggler flag from the host-0 cluster merge "
        "(1 = this host's step-time p50 exceeds the cluster median by "
        "more than PADDLE_TPU_STRAGGLER_PCT percent, 0 = on pace; label "
        "space bounded by world size)", labels=("host",)),
}
