"""Kernel autotuner: timed variant/config selection for the CUDA kernels
(port of ``paddle_tpu/kernels/autotune.py``).

- a **registry** of kernel families (here flash_fwd, flash_bwd,
  flash_bwd_dq, flash_bwd_dkv, registered by
  :mod:`.flash_attention_cuda`, and decode_attn and decode_attn_paged,
  registered by :mod:`.decode_attention`), each exposing the per-key candidate list
  (variant name + config dict; candidate [0] is ALWAYS the hand-tuned
  default), a runner that executes one candidate on synthetic data, and
  optionally ``smem_bytes``, the dynamic shared memory a candidate's
  launch asks for;
- **timed selection** at first call per (shape, dtype, platform, causal)
  key: median-of-k wall times per candidate, best wins (off by default:
  enable with FLAGS_autotune=1 / PADDLE_TPU_AUTOTUNE=1, or warm
  explicitly through the CLI);
- a **persistent JSON cache** (`PADDLE_TPU_AUTOTUNE_CACHE`, default
  `~/.cache/paddle_tpu_torch/autotune.json`, apart from the JAX
  package's; the empty string disables it) plus an in-process memo, so
  tuning is paid once per machine;
- **pin overrides**: `FLAGS_autotune_pin` / `PADDLE_TPU_AUTOTUNE_PIN` =
  ``"family=variant[:k=v,...][;family2=...]"`` forces a candidate without
  timing (highest precedence: above memo, cache and tuning);
- a **CLI**: ``python -m paddle_tpu_torch.kernels.autotune
  dump|table|clear|warm`` to inspect, reset or pre-populate the cache.

The JAX package prices each candidate's VMEM working set before it
compiles; here a family's ``smem_bytes`` hook is held against the card's
opt-in shared-memory limit per block, and a candidate above it is
recorded as ``rejected: smem`` without a launch.  As in the JAX
package, ``resolve()`` counts ``autotune.cache_hits`` (a pin, the memo or
the cache answered) and ``autotune.cache_misses`` in the metrics
registry, ``tune()`` observes ``autotune.tune_seconds`` and runs inside
the ``autotune.tune`` liveness beacon.

With tuning disabled, no pin and no cache entry, ``resolve()`` returns
the registered default, so every kernel launches as the hand-tuned path
does.  Importing this module compiles and loads nothing.
"""
from __future__ import annotations

import json
import os
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..observability import liveness as _liveness
from ..observability import registry as _obs

__all__ = [
    "register_family", "resolve", "tune", "warm", "clear_cache",
    "cache_path", "enabled", "key_str", "families",
]

DEFAULT_CACHE = os.path.join("~", ".cache", "paddle_tpu_torch",
                             "autotune.json")
_CACHE_VERSION = 1

_LOCK = threading.RLock()
_FAMILIES: Dict[str, "KernelFamily"] = {}
#: (family, key_str) -> candidate dict: the in-process memo, hit on every
#: call after the first (resolve() runs on every eager kernel call).
#: Holds TUNED/CACHED picks only; defaults memoise separately in
#: _MEMO_DEFAULT so enabling autotune mid-process still tunes keys that
#: were first resolved while tuning was off.
_MEMO: Dict[tuple, Dict[str, Any]] = {}
_MEMO_DEFAULT: Dict[tuple, Dict[str, Any]] = {}
#: (family, key_str) -> candidate as last RETURNED by resolve(), pins
#: included, so report() reflects what actually ran
_RESOLVED: Dict[tuple, Dict[str, Any]] = {}
_CACHE: Optional[dict] = None
_CACHE_LOADED_FROM: Optional[str] = None

# liveness beacon over one timed candidate selection: candidates build
# and run on the card in a loop, and a hung card wedges the warm
# silently.  900 s default: a full family sweep times every candidate
_liveness.declare_beacon(
    "autotune.tune", "one timed autotune selection (compile + time "
    "every candidate for one key)", deadline=900.0)


class KernelFamily:
    """One tunable kernel family.

    ``candidates(key)`` returns the ordered candidate list for a key dict,
    each ``{"variant": str, "config": {...}}``, candidate [0] the
    hand-tuned default.  ``runner(candidate, key)`` builds a zero-arg
    callable that executes the candidate on synthetic data of the key's
    shape/dtype and synchronises the device before it returns (None
    runner = resolvable but not timeable: resolve() falls back to the
    default instead of tuning).  ``cleanup(key)`` frees the synthetic
    operands the runners cached for a key.  ``smem_bytes(candidate, key)``
    is the dynamic shared memory the candidate's launch asks for, or None
    when the family has no such limit.
    """

    def __init__(self, name: str,
                 candidates: Callable[[dict], List[dict]],
                 runner: Optional[Callable[[dict, dict], Callable]] = None,
                 cleanup: Optional[Callable[[dict], None]] = None,
                 smem_bytes: Optional[Callable[[dict, dict], int]] = None):
        self.name = name
        self.candidates = candidates
        self.runner = runner
        self.cleanup = cleanup
        self.smem_bytes = smem_bytes


def register_family(name: str, candidates, runner=None, cleanup=None,
                    smem_bytes=None) -> KernelFamily:
    fam = KernelFamily(name, candidates, runner, cleanup, smem_bytes)
    with _LOCK:
        _FAMILIES[name] = fam
    return fam


def families() -> Dict[str, KernelFamily]:
    return dict(_FAMILIES)


# ---------------------------------------------------------------------------
# keys, flags, pins
# ---------------------------------------------------------------------------

def platform(device=None) -> str:
    """``"gpu"`` for a CUDA device, else ``"cpu"``; with no device, the
    default one (a card when one is present)."""
    import torch
    if device is None:
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def key_str(key: dict) -> str:
    """Canonical cache key: sorted k=v pairs (values stringified)."""
    return ",".join("%s=%s" % (k, key[k]) for k in sorted(key))


def _flag(name):
    from ..utils import flags as _flags
    return _flags.fast_get(name)


def enabled() -> bool:
    """Timed selection on unseen keys (pins/cache/memo are always live)."""
    if os.environ.get("PADDLE_TPU_AUTOTUNE", "").lower() in ("1", "true",
                                                             "yes"):
        return True
    return bool(_flag("autotune"))


def _single_process() -> bool:
    """Lazy in-line tuning is restricted to single-process jobs: ranks
    timing candidates independently can pick DIFFERENT variants for the
    same key and run diverging kernels across replicas.  Multi-process
    jobs pre-tune (``python -m paddle_tpu_torch.kernels.autotune warm`` on
    one host) and ship the cache file to every rank
    (PADDLE_TPU_AUTOTUNE_CACHE): cache/pin resolution is deterministic."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


def _samples() -> int:
    env = os.environ.get("PADDLE_TPU_AUTOTUNE_SAMPLES")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    v = _flag("autotune_samples")
    return max(1, int(v)) if v else 5


def cache_path() -> Optional[str]:
    """Cache file path, or None when persistence is disabled
    (PADDLE_TPU_AUTOTUNE_CACHE set to the empty string)."""
    raw = os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE")
    if raw is None:
        raw = DEFAULT_CACHE
    if not raw:
        return None
    return os.path.expanduser(raw)


def _parse_scalar(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _pins() -> Dict[str, dict]:
    """``family=variant[:k=v,...];...`` -> {family: {variant, config}}.
    FLAGS_autotune_pin wins over the PADDLE_TPU_AUTOTUNE_PIN env."""
    raw = _flag("autotune_pin") or os.environ.get(
        "PADDLE_TPU_AUTOTUNE_PIN", "")
    out = {}
    for part in str(raw).split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        fam, _, rest = part.partition("=")
        variant, _, cfg_s = rest.partition(":")
        config = {}
        for kv in cfg_s.split(","):
            if "=" in kv:
                ck, _, cv = kv.partition("=")
                config[ck.strip()] = _parse_scalar(cv.strip())
        out[fam.strip()] = {"variant": variant.strip(), "config": config}
    return out


# ---------------------------------------------------------------------------
# persistent cache
# ---------------------------------------------------------------------------

def _load_cache() -> dict:
    global _CACHE, _CACHE_LOADED_FROM
    path = cache_path()
    with _LOCK:
        if _CACHE is not None and _CACHE_LOADED_FROM == path:
            return _CACHE
    # file I/O outside the lock: racing first loads both read the file;
    # the loser re-checks below and adopts the winner's copy
    data = {"version": _CACHE_VERSION, "families": {}}
    if path and os.path.isfile(path):
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and \
                    loaded.get("version") == _CACHE_VERSION:
                data = loaded
        except (OSError, ValueError):
            pass  # unreadable/corrupt cache = empty cache
    with _LOCK:
        if _CACHE is None or _CACHE_LOADED_FROM != path:
            _CACHE = data
            _CACHE_LOADED_FROM = path
        return _CACHE


def _save_cache():
    path = cache_path()
    if not path or _CACHE is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump(_CACHE, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only FS etc.: the memo still holds the result


def clear_cache(in_process_too: bool = True):
    """Delete the persistent cache file (and the in-process memo)."""
    global _CACHE, _CACHE_LOADED_FROM
    with _LOCK:
        path = cache_path()
        if path and os.path.isfile(path):
            os.remove(path)
        _CACHE = None
        _CACHE_LOADED_FROM = None
        if in_process_too:
            _MEMO.clear()
            _MEMO_DEFAULT.clear()


# ---------------------------------------------------------------------------
# timing + selection
# ---------------------------------------------------------------------------

def _time_callable(fn: Callable, samples: int) -> float:
    """Median-of-``samples`` wall ms.  ``fn`` must synchronise the device
    before it returns (the runners call torch.cuda.synchronize()).  One
    untimed warm-up run absorbs the kernel library's first load."""
    fn()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return float(statistics.median(times))


def _cand_sig(cand: dict) -> str:
    cfg = cand.get("config", {})
    return cand["variant"] + ":" + ",".join(
        "%s=%s" % (k, cfg[k]) for k in sorted(cfg))


_SMEM_OPTIN: Dict[int, int] = {}


def smem_limit(device) -> Optional[int]:
    """The dynamic shared memory a block may opt in to on a CUDA device
    (memoised per card); None for any other device."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMEM_OPTIN:
        _SMEM_OPTIN[idx] = int(torch.cuda.get_device_properties(idx)
                               .shared_memory_per_block_optin)
    return _SMEM_OPTIN[idx]


def _smem_limit(key: dict) -> Optional[int]:
    """The shared-memory limit ``tune()`` holds a key's candidates to: the
    current card's, for a key of the "gpu" platform; None elsewhere."""
    import torch
    if key.get("platform") != "gpu" or not torch.cuda.is_available():
        return None
    return smem_limit(torch.device("cuda"))


def _smem_reject(fam: KernelFamily, cand: dict, key: dict,
                 limit: Optional[int]) -> Optional[str]:
    """Non-empty rejection reason when the candidate's launch would ask
    for more shared memory than a block may use: the launch would be
    refused, so it is never made."""
    if fam.smem_bytes is None or limit is None:
        return None
    need = fam.smem_bytes(cand, key)
    if need is None or need <= limit:
        return None
    return "rejected: smem (%d > %d)" % (need, limit)


def tune(family_name: str, key: dict, persist: bool = True,
         verbose: bool = False, run_cleanup: bool = True) -> dict:
    """Time every candidate for ``key`` and select the fastest.

    Candidates whose build/run raises are recorded as failed and skipped;
    candidates above the shared-memory limit are recorded as rejected and
    never launched.  The winner is memoised and, when ``persist``, written
    to the JSON cache with the full timing table.  ``run_cleanup=False``
    defers the family's operand-cache cleanup to the caller (warm()
    batches several families over the same key).
    """
    import torch
    fam = _FAMILIES[family_name]
    if fam.runner is None:
        raise ValueError("family %r has no runner registered" % family_name)
    cands = fam.candidates(key)
    if not cands:
        raise ValueError("family %r produced no candidates for %s"
                         % (family_name, key))
    ks = key_str(key)
    samples = _samples()
    limit = _smem_limit(key)
    timings: Dict[str, Any] = {}
    best, best_ms = None, None
    t_start = time.perf_counter()
    try:
        # tune() is cold-path: fetching the beacon per call is fine
        with _liveness.beacon("autotune.tune"), \
                torch.profiler.record_function(
                    "autotune::%s::%s" % (family_name, ks)):
            for cand in cands:
                sig = _cand_sig(cand)
                rejected = _smem_reject(fam, cand, key, limit)
                if rejected:
                    timings[sig] = rejected
                    if verbose:
                        print("  %-48s %s" % (sig, rejected))
                    continue
                try:
                    fn = fam.runner(cand, key)
                    ms = _time_callable(fn, samples)
                except Exception as e:  # candidate illegal at this key
                    timings[sig] = "failed: %s" % type(e).__name__
                    if verbose:
                        print("  %-48s %s" % (sig, timings[sig]))
                    continue
                timings[sig] = round(ms, 4)
                if verbose:
                    print("  %-48s %10.3f ms" % (sig, ms))
                if best_ms is None or ms < best_ms:
                    best, best_ms = cand, ms
    finally:
        _obs.histogram("autotune.tune_seconds").observe(
            time.perf_counter() - t_start)
        if run_cleanup and fam.cleanup is not None:
            fam.cleanup(key)
    if best is None:
        # nothing timed successfully.  A candidate above the
        # shared-memory limit must NEVER be the fallback (its launch is
        # refused); fall back to the first candidate that at least fits
        # (runtime failures may be transient/key-specific), and fail
        # loudly when none fits at all.
        smem_rejected = {sig for sig, v in timings.items()
                         if isinstance(v, str)
                         and v.startswith("rejected: smem")}
        best = next((c for c in cands
                     if _cand_sig(c) not in smem_rejected), None)
        if best is None:
            raise ValueError(
                "autotune %s [%s]: no candidate fits the shared memory "
                "of a block: %s" % (family_name, ks, "; ".join(
                    "%s -> %s" % kv for kv in sorted(timings.items()))))
        best_ms = float("nan")
    entry = {"variant": best["variant"], "config": dict(best["config"]),
             "ms": None if best_ms != best_ms else round(best_ms, 4),
             "samples": samples, "timings": timings}
    with _LOCK:
        _MEMO[(family_name, ks)] = {"variant": entry["variant"],
                                    "config": dict(entry["config"])}
        if persist:
            cache = _load_cache()
            cache.setdefault("families", {}).setdefault(
                family_name, {})[ks] = entry
            _save_cache()
    return _MEMO[(family_name, ks)]


def resolve(family_name: str, key: dict) -> dict:
    """The lookup the kernel wrappers make on every call.

    Precedence: pin override > in-process memo > persistent cache > timed
    selection (only when autotuning is enabled) > registered default.
    Always returns ``{"variant": str, "config": dict}``.
    """
    fam = _FAMILIES.get(family_name)
    if fam is None:
        raise KeyError("unknown autotune family %r" % family_name)
    ks = key_str(key)

    def _log(cand):
        with _LOCK:
            _RESOLVED[(family_name, ks)] = cand
        return cand

    pin = _pins().get(family_name)
    if pin is not None:
        default = fam.candidates(key)[0]
        _obs.counter("autotune.cache_hits").inc()
        return _log({"variant": pin["variant"] or default["variant"],
                     "config": {**default["config"], **pin["config"]}})
    with _LOCK:
        hit = _MEMO.get((family_name, ks))
        if hit is not None:
            _RESOLVED[(family_name, ks)] = hit
            _obs.counter("autotune.cache_hits").inc()
            return hit
        entry = _load_cache().get("families", {}).get(
            family_name, {}).get(ks)
        if entry is not None:
            cand = {"variant": entry["variant"],
                    "config": dict(entry["config"])}
            _MEMO[(family_name, ks)] = cand
            _RESOLVED[(family_name, ks)] = cand
            _obs.counter("autotune.cache_hits").inc()
            return cand
        _obs.counter("autotune.cache_misses").inc()
    if enabled() and fam.runner is not None and _single_process():
        return _log(tune(family_name, key))
    with _LOCK:
        default = _MEMO_DEFAULT.get((family_name, ks))
        if default is None:
            default = fam.candidates(key)[0]
            _MEMO_DEFAULT[(family_name, ks)] = default
    return _log(default)


def report() -> Dict[str, Dict[str, dict]]:
    """Snapshot of every candidate resolved in THIS process (pins
    included), keyed family -> key_str -> candidate: what ran."""
    with _LOCK:
        out: Dict[str, Dict[str, dict]] = {}
        for (fam, ks), cand in sorted(_RESOLVED.items()):
            out.setdefault(fam, {})[ks] = {"variant": cand["variant"],
                                           "config": dict(cand["config"])}
        return out


# ---------------------------------------------------------------------------
# warm: pre-populate the cache for the bench-standard keys
# ---------------------------------------------------------------------------

def _import_kernel_families():
    """Family registration happens at kernel-module import."""
    from . import decode_attention  # noqa: F401
    from . import flash_attention_cuda  # noqa: F401


def standard_keys() -> List[tuple]:
    """(family, key) pairs for the GPT-2 345M bench shapes: what the CLI
    warms by default — the four flash families at the training shape,
    the slotted decode attention at the serving shape (8 slots, a
    1024-token cache) and the paged one there (pages of 64, 16 a slot, a
    pool for all 8 at full depth): one token a step, the int8 pool, and
    the speculative verify step (``qlen`` 5, four drafts), as the JAX
    package's keys, the tensor-parallel paged key (tp=2: 8 of the 16
    heads a rank), and the chunk count of the tp=2 row ring at the
    projection shape (the ``mp_overlap`` family of
    :mod:`paddle_tpu_torch.distributed.mp_overlap`, timed over two
    ranks).  The families ce_lse and ln are not registered (ROADMAP
    §C)."""
    _import_kernel_families()
    from ..distributed import mp_overlap as mpo
    from . import decode_attention as dat
    from . import flash_attention_cuda as fac
    dtype = "bfloat16" if platform() == "gpu" else "float32"

    def paged(qlen, kv_dtype=None, tp=1):
        return ("decode_attn_paged", dat.paged_autotune_key(
            slots=8, pages=128, page_size=64, max_pages=16, h=16, d=64,
            qlen=qlen, dtype=dtype, kv_dtype=kv_dtype, tp=tp))
    return [(fam_name, fac.autotune_key(b=8, s=1024, sk=1024, h=16, d=64,
                                        dtype=dtype, causal=True))
            for fam_name in ("flash_fwd", "flash_bwd", "flash_bwd_dq",
                             "flash_bwd_dkv")] + [
        ("decode_attn", dat.autotune_key(slots=8, t=1024, h=16, d=64,
                                         qlen=1, dtype=dtype)),
        paged(1), paged(1, "int8"), paged(5), paged(1, tp=2),
        ("mp_overlap", mpo.autotune_key(kind="row", m=8, k=4096 // 2,
                                        n=1024, n_dev=2, dtype=dtype))]


def warm(pairs=None, verbose: bool = True) -> List[dict]:
    """Tune every (family, key) pair (default: the bench-standard set) and
    persist the results.  Per-family operand-cache cleanups are deferred
    to the END of the batch: the four flash families share one per-key
    synthetic operand set."""
    _import_kernel_families()
    if pairs is None:
        pairs = standard_keys()
    results = []
    try:
        for fam_name, key in pairs:
            if verbose:
                print("tuning %s [%s] on %s ..." % (fam_name, key_str(key),
                                                    key.get("platform")))
            cand = tune(fam_name, key, verbose=verbose, run_cleanup=False)
            if verbose:
                print("  -> %s %s" % (cand["variant"], cand["config"]))
            results.append(cand)
    finally:
        for fam_name, key in pairs:
            fam = _FAMILIES.get(fam_name)
            if fam is not None and fam.cleanup is not None:
                fam.cleanup(key)
    return results


# ---------------------------------------------------------------------------
# CLI: python -m paddle_tpu_torch.kernels.autotune {dump,table,clear,warm}
# ---------------------------------------------------------------------------

def _cli_table():
    cache = _load_cache()
    fams = cache.get("families", {})
    if not any(fams.values()):
        print("autotune cache empty (%s)" % (cache_path() or "disabled"))
        return
    for fam_name in sorted(fams):
        for ks, entry in sorted(fams[fam_name].items()):
            print("%s [%s]" % (fam_name, ks))
            print("  chosen: %s %s  (median %s ms of %s)" % (
                entry["variant"], entry["config"], entry.get("ms"),
                entry.get("samples")))
            for sig, ms in sorted(entry.get("timings", {}).items(),
                                  key=lambda kv: (isinstance(kv[1], str),
                                                  kv[1])):
                print("    %-52s %s" % (sig, ms if isinstance(ms, str)
                                        else "%.3f ms" % ms))


def _cli_main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.kernels.autotune",
        description="Inspect, clear or warm the kernel autotune cache.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("dump", help="print the raw cache JSON")
    sub.add_parser("table", help="print a per-key timing table")
    sub.add_parser("clear", help="delete the cache file")
    w = sub.add_parser("warm", help="run timed selection for the "
                       "bench-standard keys on this platform")
    w.add_argument("--family", help="warm only this family")
    w.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "dump":
        print(json.dumps(_load_cache(), indent=1, sort_keys=True))
    elif args.cmd == "table":
        _cli_table()
    elif args.cmd == "clear":
        path = cache_path()
        clear_cache()
        print("cleared %s" % (path or "(persistence disabled)"))
    elif args.cmd == "warm":
        pairs = standard_keys()
        if args.family:
            pairs = [(f, k) for f, k in pairs if f == args.family]
            if not pairs:
                raise SystemExit("no standard key for family %r"
                                 % args.family)
        warm(pairs, verbose=not args.quiet)
        _cli_table()
    return 0


if __name__ == "__main__":
    # run as a script, this file is a second module object beside the
    # package's ``paddle_tpu_torch.kernels.autotune``, where the kernel
    # modules register their families: the CLI runs on that one
    from paddle_tpu_torch.kernels import autotune as _package_module
    raise SystemExit(_package_module._cli_main())
