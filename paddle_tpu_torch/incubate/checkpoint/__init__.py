"""Fault-tolerant checkpointing (port of
``paddle_tpu/incubate/checkpoint``; reference:
``python/paddle/fluid/incubate/checkpoint/auto_checkpoint.py`` —
AutoCheckpointChecker:71, TrainEpochRange:265 — and
``checkpoint_saver.py``).

The unit of persistence is a tree (dicts, lists, tuples) of tensors,
numpy arrays and Python data — parameters, optimizer slots, LR state,
generator states, the data cursor — saved

* **per rank** — each ``torch.distributed`` rank (the JAX package's
  "host") writes ``host-<rank>.ckpt`` and its manifest into the step's
  directory, and rank 0 publishes only after it has checked every
  expected shard file against its manifest.  A leaf may be a rank's
  slice of a larger array (:func:`sliced`): restore joins the slices and
  raises when they do not cover the array;
* **async** — tensors are fetched to host numpy on the caller's thread,
  and pickling and disk IO run on a bounded writer thread, so the step
  goes on (a multi-rank save runs on the caller's thread: its barriers
  must be issued from the main thread in the same order on every rank);
* **atomically** — shards land in ``ckpt-<step>.tmp``, renamed into place
  with a ``DONE`` marker written last; a half-written checkpoint is never
  restored.

Restore falls back from a corrupt or torn newest checkpoint to older
ones (:class:`CheckpointFallbackWarning`).  Auto-resume is
:class:`TrainEpochRange`: it restores the newest usable checkpoint into
its registered state holders and fast-forwards the data through
:class:`ResumableIterator`.  ``TrainStep.state_dict()`` holds whole
tensors (ZeRO slices gathered), so on a multi-rank run every rank writes
the whole state where the JAX package writes a ZeRO slot's shards
(ROADMAP.md §C "Known differences").
"""
from __future__ import annotations

import atexit
import hashlib
import json
import os
import pickle
import queue
import re
import shutil
import sys
import threading
import time
import warnings
import weakref
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ...observability import liveness as _liveness
from ...observability import registry as _metrics
from ...robustness import retry as _retry
from ...robustness.faultpoints import declare as _declare, faultpoint

# one full checkpoint write (shard + manifest + barriers + publish), on the
# writer thread or inline: the hang it watches for is a write that never
# returns
_liveness.declare_beacon(
    "checkpoint.writer", "one checkpoint save drained by the writer "
    "(shard write + manifest + publish barriers)", deadline=600.0)

__all__ = ["CheckpointManager", "ResumableIterator", "TrainEpochRange",
           "CheckpointWriteError", "CheckpointCorruptionError",
           "NoUsableCheckpointError", "CheckpointFallbackWarning", "sliced",
           "step_generators"]

_declare("checkpoint.shard_write",
         "raise before a host's shard pickle hits disk (ENOSPC, EIO)")
_declare("checkpoint.shard_file",
         "mutate the landed shard file pre-publish (torn write, bit rot)")
_declare("checkpoint.publish",
         "raise/crash between shard verification and the DONE marker")
_declare("checkpoint.restore_read",
         "mutate/raise before a shard file is read back at restore")
_declare("train.epoch",
         "TrainEpochRange epoch boundary (Preempt here simulates SIGTERM "
         "between epochs)")


class CheckpointWriteError(RuntimeError):
    """A checkpoint could not be safely published (missing/short shard
    after the write barrier).  The step directory holds no DONE marker."""


class CheckpointCorruptionError(ValueError):
    """A published checkpoint failed integrity verification on restore
    (manifest sha256/size mismatch, unpicklable payload, missing shard)."""


class NoUsableCheckpointError(FileNotFoundError):
    """No checkpoint (of those requested) could be restored.  Subclasses
    FileNotFoundError so that callers' handlers of a missing file keep
    working."""


class CheckpointFallbackWarning(UserWarning):
    """Emitted when restore skips a corrupt checkpoint for an older one."""


# -- interpreter-exit flush --------------------------------------------------
# The writer is a daemon thread (a wedged write must not block interpreter
# exit forever), so queued saves would die with the process: every live
# manager is close()d — its queue drained — by one atexit hook.
_live_managers: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()
_STOP = object()


def _flush_managers_at_exit():
    for mgr in list(_live_managers):
        try:
            mgr.close()
        except BaseException as e:  # the process is exiting: report, go on
            sys.stderr.write(
                "[checkpoint] flush of %r at interpreter exit failed: %r\n"
                % (getattr(mgr, "directory", "?"), e))
            sys.stderr.flush()


atexit.register(_flush_managers_at_exit)


# --------------------------------------------------------------------------
# leaves
# --------------------------------------------------------------------------

# dtypes numpy has no type for travel as their bits
_BITS = {torch.bfloat16: torch.int16}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _BITS[getattr(torch, _name)] = torch.uint8


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t``'s values on the host as numpy (the bits, for a
    dtype numpy lacks): the writer thread pickles it after the step has
    moved on, so it must not share memory with ``t``."""
    t = t.detach()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    host = t.cpu().contiguous()
    if host.data_ptr() == t.data_ptr():
        host = host.clone()
    return host.numpy()


def _tensor_of(array: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(array))
    want = getattr(torch, dtype)
    return t.view(want) if want in _BITS else t


class _TensorLeaf:
    """A tensor's values on the host; restored as a CPU tensor of its
    dtype (or placed like the template's tensor)."""

    def __init__(self, t: torch.Tensor):
        self.dtype = _dtype_name(t.dtype)
        self.array = _host_array(t)

    def tensor(self) -> torch.Tensor:
        return _tensor_of(self.array, self.dtype)


class _ShardedLeaf:
    """One rank's slices of an array of ``shape``, with where each lies
    (``index``: a (start, stop) pair a dimension).  Restore merges every
    rank's slices and checks that they cover the array: a missing or
    torn shard raises rather than leaving zeros."""

    def __init__(self, shape, dtype: str, shards):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.shards = list(shards)      # [(index, np array)]

    def assemble(self) -> torch.Tensor:
        first = self.shards[0][1] if self.shards else None
        out = np.zeros(self.shape, dtype=first.dtype if first is not None
                       else np.float32)
        # identical indices are replicas; unique ones must partition it
        covered = 0
        seen = set()
        total = int(np.prod(self.shape)) if self.shape else 1
        for idx, data in self.shards:
            out[tuple(slice(a, b) for a, b in idx)] = data
            if idx not in seen:
                seen.add(idx)
                covered += int(np.prod([b - a for a, b in idx])) if idx \
                    else 1
        if covered < total:
            raise ValueError(
                f"sharded checkpoint leaf of shape {self.shape} has only "
                f"{covered}/{total} elements ({len(self.shards)} shards) — "
                "a per-host shard file is missing or torn")
        return _tensor_of(out, self.dtype)


def sliced(t: torch.Tensor, shape, index) -> _ShardedLeaf:
    """A leaf to save in place of a whole tensor: ``t`` is this rank's
    slice ``index`` (a (start, stop) pair a dimension) of an array of
    ``shape``.  Restore returns the whole array, joined from every
    rank's slices."""
    index = tuple((int(a), int(b)) for a, b in index)
    if tuple(b - a for a, b in index) != tuple(t.shape):
        raise ValueError("sliced: index %r does not match the slice's "
                         "shape %r" % (index, tuple(t.shape)))
    return _ShardedLeaf(shape, _dtype_name(t.dtype), [(index,
                                                        _host_array(t))])


def _to_host(obj):
    """Fetch tensors to host leaves (runs on the caller's thread)."""
    if isinstance(obj, torch.Tensor):
        return _TensorLeaf(obj)
    if isinstance(obj, _ShardedLeaf):
        return obj
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _from_host(obj, template=None):
    """Tensors back; a tensor in ``template`` at the same place gives the
    restored one its device and dtype."""
    if isinstance(obj, (_TensorLeaf, _ShardedLeaf)):
        t = obj.tensor() if isinstance(obj, _TensorLeaf) else obj.assemble()
        if isinstance(template, torch.Tensor):
            return t.to(device=template.device, dtype=template.dtype)
        return t
    if isinstance(obj, np.ndarray):
        if isinstance(template, torch.Tensor):
            return torch.as_tensor(obj).to(device=template.device,
                                           dtype=template.dtype)
        return obj
    if isinstance(obj, dict):
        return {k: _from_host(v, template.get(k)
                              if isinstance(template, dict) else None)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        tmpl = template if isinstance(template, (list, tuple)) \
            and len(template) == len(obj) else [None] * len(obj)
        return type(obj)(_from_host(v, t) for v, t in zip(obj, tmpl))
    return obj


def _merge_shards(a, b):
    if isinstance(a, _ShardedLeaf) and isinstance(b, _ShardedLeaf):
        a.shards.extend(b.shards)
        return a
    if isinstance(a, dict):
        return {k: _merge_shards(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_merge_shards(x, y) for x, y in zip(a, b))
    return a


# --------------------------------------------------------------------------
# manager
# --------------------------------------------------------------------------

class _HashingWriter:
    """File-like pass-through that sha256s and counts what pickle streams
    through it: the manifest's view of the intended shard bytes, with no
    second copy of them in memory."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()
        self.nbytes = 0

    def write(self, data):
        self.sha.update(data)
        self.nbytes += len(data)
        return self._f.write(data)


def _world():
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointManager:
    """Directory of ``ckpt-<step>`` checkpoints with async save, per-rank
    shard files, atomic publish, retention and newest-usable restore.

    Several ranks need ``directory`` on one filesystem that all of them
    see: each writes its ``host-<rank>.ckpt`` into the same
    ``ckpt-<step>`` directory, and rank 0 publishes the DONE marker only
    after checking every expected shard file there."""

    _STEP_RE = re.compile(r"^ckpt-(\d+)$")

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._host, self._nhosts = _world()
        # bounded: save() waits rather than stack host copies of the state
        # when IO is slower than the step
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        if async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True,
                                            name="checkpoint-writer")
            self._worker.start()
        # fetched once; the NOOP_BEACON singleton when liveness is off
        self._beacon = _liveness.beacon("checkpoint.writer")
        _live_managers.add(self)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, wait: bool = False):
        """Snapshot ``state`` as checkpoint ``step``.  Tensors are fetched
        now; IO runs on the writer thread unless ``wait``,
        ``async_save=False`` or several ranks."""
        if self._closed:
            raise RuntimeError(
                "CheckpointManager(%r) is closed — no further saves"
                % self.directory)
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("previous async checkpoint failed") from err
        payload = _to_host(state)
        # several ranks publish through barriers, which must run on the
        # main thread in the same order on every rank (on the writer
        # thread they could interleave with the step's collectives)
        if self.async_save and not wait and self._nhosts == 1:
            self._q.put((step, payload))
        else:
            self._write(step, payload)
        if wait:
            self.wait()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                self._q.task_done()
                return
            step, payload = item
            try:
                self._write(step, payload)
            except BaseException as e:  # surfaced on next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    @staticmethod
    def _manifest_name(host: int) -> str:
        return f"host-{host}.manifest.json"

    def _write(self, step: int, payload):
        with self._beacon:
            return self._write_guarded(step, payload)

    def _write_guarded(self, step: int, payload):
        t0 = time.perf_counter()
        final = os.path.join(self.directory, f"ckpt-{step}")
        tmp = final + ".tmp"
        if self._host == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            shutil.rmtree(final, ignore_errors=True)
        # every rank must see the cleaned tmp dir before anyone writes
        # into it, or rank 0's rmtree can delete a peer's shard file
        self._barrier()
        os.makedirs(tmp, exist_ok=True)
        shard = os.path.join(tmp, f"host-{self._host}.ckpt")
        faultpoint("checkpoint.shard_write", path=shard, step=step)
        # the manifest describes the intended bytes (a write torn between
        # here and publish no longer hashes to it), hashed as pickle
        # streams out rather than from a second copy in memory
        with open(shard, "wb") as f:
            writer = _HashingWriter(f)
            pickle.dump(payload, writer, protocol=4)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, self._manifest_name(self._host)),
                  "w") as f:
            json.dump({"sha256": writer.sha.hexdigest(),
                       "nbytes": writer.nbytes,
                       "host": self._host, "step": step}, f)
            f.flush()
            os.fsync(f.fileno())
        faultpoint("checkpoint.shard_file", path=shard, step=step)
        # every rank's shard is durable before rank 0 publishes
        self._barrier()
        if self._host == 0:
            self._verify_shards_before_publish(tmp, final)
            faultpoint("checkpoint.publish", path=final, step=step)
            os.replace(tmp, final)
            with open(os.path.join(final, "DONE"), "w") as f:
                f.write(str(self._nhosts))
            self._retain()
        # recorded for a completed save only
        _metrics.histogram("checkpoint.write_seconds").observe(
            time.perf_counter() - t0)
        _metrics.histogram("checkpoint.write_bytes").observe(writer.nbytes)

    def _verify_shards_before_publish(self, tmp: str, final: str):
        """Rank 0, before DONE: every rank's shard is in the shared
        directory and has its manifest's size.  open() (not exists) with
        retries: a network filesystem can report a peer's new file absent
        for a while."""
        def stat_visible(path):
            def attempt():
                with open(path, "rb"):
                    return os.path.getsize(path)
            try:
                return _retry.retry_call(
                    attempt, retry_on=OSError, tries=8, base_delay=0.05,
                    max_delay=1.0, deadline=5.0,
                    name="checkpoint.shard_visible")
            except _retry.RetryError:
                return None

        missing, torn = [], []
        for i in range(self._nhosts):
            size = stat_visible(os.path.join(tmp, f"host-{i}.ckpt"))
            if size is None:
                missing.append(i)
                continue
            try:
                with open(os.path.join(tmp, self._manifest_name(i))) as f:
                    want = int(json.load(f)["nbytes"])
            except (OSError, ValueError, KeyError):
                missing.append(i)  # no readable manifest: not verifiable
                continue
            if size != want:
                torn.append((i, size, want))
        if missing or torn:
            raise CheckpointWriteError(
                "checkpoint %s NOT published: %s%s — the checkpoint "
                "directory must be one shared filesystem and every shard "
                "write must complete"
                % (final,
                   ("shard/manifest files for hosts %r absent after the "
                    "write barrier" % missing) if missing else "",
                   ("; torn shard writes %s (host, bytes-on-disk, "
                    "bytes-expected)" % torn) if torn else ""))

    def _barrier(self):
        if self._nhosts > 1:
            import torch.distributed as dist
            dist.barrier()

    def _retain(self):
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(os.path.join(self.directory, f"ckpt-{s}"),
                          ignore_errors=True)

    def wait(self):
        """Block until all queued saves are on disk."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint failed") from err

    #: total budget for close(): enough for a slow flush of the queue,
    #: but bounded — a wedged write must not stall interpreter exit
    _CLOSE_TIMEOUT = 600.0

    def close(self):
        """Flush queued saves and stop the writer, within
        ``_CLOSE_TIMEOUT``.  Idempotent; runs at interpreter exit for
        every live manager, so an async ``save()`` right before exit still
        lands.  Raises if a queued save failed; warns on stderr if the
        flush did not finish in time."""
        if self._closed:
            return
        self._closed = True
        deadline = time.monotonic() + self._CLOSE_TIMEOUT
        worker, self._worker = self._worker, None
        if worker is not None and worker.is_alive():
            try:
                self._q.put(_STOP, timeout=max(
                    0.0, deadline - time.monotonic()))
            except queue.Full:
                pass  # wedged writer: the drainer below takes what is left
            worker.join(timeout=max(0.0, deadline - time.monotonic()))
        # what the worker did not get to is drained on a fresh daemon
        # thread with a bounded join: a write on a wedged filesystem can
        # block for ever, and close() (at exit) must not
        drainer = threading.Thread(target=self._drain_remaining,
                                   daemon=True, name="checkpoint-drain")
        drainer.start()
        drainer.join(timeout=max(0.1, deadline - time.monotonic()))
        if drainer.is_alive() or (worker is not None and worker.is_alive()):
            sys.stderr.write(
                "[checkpoint] close(%r) exceeded its %.0fs budget with "
                "~%d save(s) unflushed — the filesystem is wedged; those "
                "checkpoints are lost (older complete checkpoints remain "
                "restorable)\n"
                % (self.directory, self._CLOSE_TIMEOUT, self._q.qsize()))
            sys.stderr.flush()
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(
                "async checkpoint failed during close") from err

    def _drain_remaining(self):
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            try:
                if item is not _STOP:
                    step, payload = item
                    self._write(step, payload)
            except BaseException as e:
                self._err = e
            finally:
                self._q.task_done()

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = self._STEP_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, "DONE")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template: Any = None,
                fallback: Optional[bool] = None):
        """Load checkpoint ``step`` (default: the newest complete one).
        Tensors come back on the CPU, or on the device and in the dtype
        of the tensor at the same place in ``template``.

        ``fallback`` (default: True when ``step`` is None, False when a
        step is named): on a corrupt, torn or unpicklable checkpoint,
        warn (:class:`CheckpointFallbackWarning`) and try the next older
        complete one.  Only :class:`NoUsableCheckpointError` escapes a
        restore with fallback, and it names every failure."""
        t0 = time.perf_counter()
        if step is None:
            candidates = list(reversed(self.all_steps()))
            if fallback is None:
                fallback = True
        else:
            candidates = [step]
            if fallback is None:
                fallback = False
        if not candidates:
            raise NoUsableCheckpointError(
                f"no complete checkpoint in {self.directory}")
        merged, failures = None, []
        for s in candidates:
            try:
                merged = self._read_step(s)
                break
            except Exception as e:
                if not fallback:
                    raise
                failures.append((s, e))
                warnings.warn(
                    "checkpoint ckpt-%d in %s is unusable (%s: %s) — "
                    "falling back to an older checkpoint"
                    % (s, self.directory, type(e).__name__, e),
                    CheckpointFallbackWarning, stacklevel=2)
        if merged is None:
            raise NoUsableCheckpointError(
                "no usable checkpoint in %s — every candidate failed: %s"
                % (self.directory,
                   "; ".join("ckpt-%d: %s: %s" % (s, type(e).__name__, e)
                             for s, e in failures)))
        # The JAX package notes the host-side tree's bytes in its HBM
        # ledger here (the restore-time transient); the port's ledger is
        # not ported yet (ROADMAP.md §A6, observability/hbm.py).
        out = _from_host(merged, template)
        _metrics.histogram("checkpoint.restore_seconds").observe(
            time.perf_counter() - t0)
        return out

    def _read_step(self, step: int):
        """Read, verify and merge one checkpoint's shard files.  Raises
        :class:`CheckpointCorruptionError` on a manifest mismatch or an
        unpicklable payload; transient read errors are retried."""
        d = os.path.join(self.directory, f"ckpt-{step}")
        with open(os.path.join(d, "DONE")) as f:
            expected_hosts = int(f.read().strip() or 1)
        merged = None
        n_files = 0
        for name in sorted(os.listdir(d)):
            if not name.endswith(".ckpt"):
                continue
            n_files += 1
            path = os.path.join(d, name)
            faultpoint("checkpoint.restore_read", path=path, step=step)

            def read_bytes(p=path):
                with open(p, "rb") as f:
                    return f.read()

            blob = _retry.retry_call(read_bytes, retry_on=_retry.transient,
                                     tries=4, base_delay=0.05,
                                     name="checkpoint.restore_read")
            self._verify_blob(d, name, blob)
            try:
                part = pickle.loads(blob)
            except Exception as e:
                raise CheckpointCorruptionError(
                    "checkpoint shard %s/%s is unpicklable: %r"
                    % (d, name, e)) from e
            merged = part if merged is None else _merge_shards(merged, part)
        if merged is None:
            raise NoUsableCheckpointError(
                f"checkpoint {d} has no payload files")
        if n_files != expected_hosts:
            raise CheckpointCorruptionError(
                f"checkpoint {d} has {n_files} host files but was written "
                f"by {expected_hosts} hosts — incomplete or corrupted")
        return merged

    @staticmethod
    def _verify_blob(d: str, name: str, blob: bytes):
        """Check shard bytes against the sha256 manifest written at save
        time.  A shard without a manifest verifies vacuously; a manifest
        that does not match is a :class:`CheckpointCorruptionError`."""
        host = name[len("host-"):-len(".ckpt")] if name.startswith("host-") \
            else None
        mpath = os.path.join(d, f"host-{host}.manifest.json") if host \
            else None
        if mpath is None or not os.path.exists(mpath):
            return
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            want_sha, want_n = manifest["sha256"], int(manifest["nbytes"])
        except (OSError, ValueError, KeyError) as e:
            raise CheckpointCorruptionError(
                "checkpoint manifest %s is unreadable: %r" % (mpath, e)
            ) from e
        if len(blob) != want_n:
            raise CheckpointCorruptionError(
                "checkpoint shard %s/%s is torn: %d bytes on disk, "
                "manifest recorded %d" % (d, name, len(blob), want_n))
        got_sha = hashlib.sha256(blob).hexdigest()
        if got_sha != want_sha:
            raise CheckpointCorruptionError(
                "checkpoint shard %s/%s is corrupt: sha256 %s != manifest "
                "%s" % (d, name, got_sha, want_sha))


# --------------------------------------------------------------------------
# resumable data stream
# --------------------------------------------------------------------------

class ResumableIterator:
    """A DataLoader (or any re-iterable) with a saved cursor: (epoch,
    batches consumed).  After :meth:`set_state_dict` the next pass calls
    ``set_epoch`` on the loader's batch sampler (for a repeatable
    shuffle) and skips the batches already consumed."""

    def __init__(self, loader):
        self.loader = loader
        self.epoch = 0
        self.batch = 0
        self._resuming = False

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "batch": self.batch}

    def set_state_dict(self, state: Dict[str, int]):
        self.epoch = int(state["epoch"])
        self.batch = int(state["batch"])
        self._resuming = True

    def __iter__(self):
        sampler = getattr(self.loader, "batch_sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(self.epoch)
        skip = self.batch if self._resuming else 0
        self._resuming = False
        if not skip:
            self.batch = 0
        for i, b in enumerate(iter(self.loader)):
            if i < skip:
                continue
            self.batch = i + 1
            yield b
        self.epoch += 1
        self.batch = 0


# --------------------------------------------------------------------------
# auto-resume epoch range
# --------------------------------------------------------------------------

def step_generators(step):
    """The explicit generators a ``TrainStep``'s draws come from (its
    dropout's): the step's own and any a module of its model holds, once
    each, in module order.  A checkpoint that resumes a step bit for bit
    holds their states (``TrainEpochRange.register_train_step`` saves
    them)."""
    out, seen = [], set()
    for g in [getattr(step, "generator", None)] + [
            getattr(m, "generator", None) for m in step.model.modules()]:
        if isinstance(g, torch.Generator) and id(g) not in seen:
            seen.add(id(g))
            out.append(g)
    return out


class TrainEpochRange:
    """``for epoch in TrainEpochRange(n, ...).get():`` — the reference's
    ``acp.train_epoch_range`` (auto_checkpoint.py:598): on entry it
    restores the newest usable checkpoint (if any) into the registered
    state holders; while iterating, it saves them every
    ``save_interval`` epochs and after the last."""

    def __init__(self, max_epoch_num: int, name: str = "default",
                 checkpoint_dir: Optional[str] = None, save_interval: int = 1,
                 max_to_keep: int = 3, preemption_guard=None):
        checkpoint_dir = checkpoint_dir or os.environ.get(
            "PADDLE_TPU_CHECKPOINT_DIR", f"./checkpoints/{name}")
        self.manager = CheckpointManager(checkpoint_dir,
                                         max_to_keep=max_to_keep)
        self.max_epoch_num = max_epoch_num
        self.save_interval = save_interval
        # True installs a fresh SIGTERM/SIGUSR1 guard
        # (PADDLE_TPU_PREEMPTION_SIGNAL); a PreemptionGuard is used as it
        # is.  On notice, the epoch boundary drains a synchronous
        # emergency checkpoint and exits with PREEMPTED_RC, which the
        # elastic launcher restarts without counting a crash.
        if preemption_guard is True:
            from ...robustness.preemption import PreemptionGuard
            preemption_guard = PreemptionGuard()
        self.preemption_guard = preemption_guard
        self._getters: Dict[str, Callable[[], Any]] = {}
        self._setters: Dict[str, Callable[[Any], None]] = {}
        self._start_epoch = 0
        #: the epoch the last get() resumed after (None: a fresh start)
        self.restored_epoch: Optional[int] = None

    def register(self, name: str, get_state: Callable[[], Any],
                 set_state: Callable[[Any], None]):
        """Attach a state holder (model/optimizer/scaler/iterator):
        ``get_state() -> tree`` and ``set_state(tree)``."""
        self._getters[name] = get_state
        self._setters[name] = set_state
        return self

    def register_train_step(self, step, iterator: Optional[
            ResumableIterator] = None):
        """Wire a ``jit.TrainStep`` (its state and the explicit generators
        its dropout draws from) and an optional data iterator."""
        self.register("train_step", step.state_dict, step.set_state_dict)
        gens = step_generators(step)

        def set_generators(states):
            if len(states) != len(gens):
                raise ValueError("checkpoint holds %d generator states, "
                                 "the step has %d generators"
                                 % (len(states), len(gens)))
            for g, st in zip(gens, states):
                g.set_state(torch.as_tensor(st, dtype=torch.uint8))
        self.register("generators", lambda: [g.get_state() for g in gens],
                      set_generators)
        if iterator is not None:
            self.register("data_iterator", iterator.state_dict,
                          iterator.set_state_dict)
        return self

    def get(self):
        from ...core.random import get_rng_state, set_rng_state
        # restore() without a step, so that resume rides the newest-to-
        # older fallback.  No complete checkpoint: a fresh start; all of
        # them unusable: NoUsableCheckpointError (retraining from scratch
        # without a word would be worse).
        payload = None
        if self.manager.latest_step() is not None:
            payload = self.manager.restore()
        if payload is not None:
            self.restored_epoch = int(payload["epoch"])
            self._start_epoch = self.restored_epoch + 1
            for name, setter in self._setters.items():
                if name in payload["state"]:
                    setter(payload["state"][name])
            if payload.get("rng") is not None:
                set_rng_state(payload["rng"])
        try:
            for epoch in range(self._start_epoch, self.max_epoch_num):
                yield epoch
                faultpoint("train.epoch", epoch=epoch)
                guard = self.preemption_guard
                preempted = guard is not None and guard.preempted
                if preempted or \
                        (epoch - self._start_epoch) % self.save_interval \
                        == 0 or epoch == self.max_epoch_num - 1:
                    # on preemption the save is synchronous: the grace
                    # window is short, and a queued save could be lost
                    # with the process
                    self.manager.save(epoch, {
                        "epoch": epoch,
                        "state": {n: g() for n, g in self._getters.items()},
                        "rng": get_rng_state(),
                    }, wait=preempted)
                if preempted:
                    from ...robustness.preemption import PREEMPTED_RC
                    sys.stderr.write(
                        "[checkpoint] preemption notice: emergency "
                        "checkpoint for epoch %d drained to %s; exiting "
                        "rc=%d (restart-eligible)\n"
                        % (epoch, self.manager.directory, PREEMPTED_RC))
                    sys.stderr.flush()
                    raise SystemExit(PREEMPTED_RC)
        finally:
            # drain queued saves even if the caller breaks out early: the
            # daemon writer dies with the interpreter otherwise
            self.manager.wait()
