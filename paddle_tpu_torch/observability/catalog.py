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
engine, the HTTP front end, the faultpoints and the liveness monitor.
The JAX catalog's tensor-parallel, collective, handoff, host-tier,
router, training, checkpoint, autotune, compile-watchdog and HBM-ledger
names wait for their modules (ROADMAP.md §A).

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

    # -- robustness (chaos faultpoints) -------------------------------------
    "robustness.faultpoint_fires": _m(
        "counter", "injected faults fired by the active FaultPlan",
        labels=("site",)),

    # -- liveness watchdog (observability.liveness — armed via
    # PADDLE_TPU_LIVENESS=1) --------------------------------------------------
    "liveness.stalls": _m(
        "counter", "stalls the liveness monitor fired: a declared "
        "progress beacon with work inflight made no progress past its "
        "deadline (each fire also produced an all-thread-stack flight "
        "dump; label space bounded by the declared beacon registry)",
        labels=("beacon",)),
}
