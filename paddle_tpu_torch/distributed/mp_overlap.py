"""Decomposed collective matmuls for the tensor-parallel axis (port of
``paddle_tpu/distributed/mp_overlap.py``).

The Megatron pairs meet in monolithic collectives: the row matmul's
partial sums in one all-reduce, the LM head's vocab shards in one
all-gather.  Each serializes the whole transfer before or after the whole
matmul.  This module runs each site as a ring of permutes
(:func:`.collective.ppermute`) over the ``mp`` group, so that every step
moves one block while the next block's partial matmul runs:

* :func:`row_parallel_matmul` — matmul then all-reduce becomes a
  matmul/reduce-scatter ring and a ring all-gather.  At step ``t`` rank
  ``d`` computes its partial of output block ``(d+t+1) mod n`` and adds
  the accumulator that arrived from rank ``d+1``; after ``n`` steps block
  ``d`` is reduced in place.  The backward needs no collective.
* :func:`column_parallel_matmul` — the forward is the local matmul; the
  backward runs dx's all-reduce through the same ring.
* :func:`lm_head_matmul` — a rotate-weights ring: each step matmuls the
  resident vocab shard into its slice of the logits while the next shard
  is in flight.  The full logits come back on every rank.
* :func:`vocab_embed` — a masked local gather and one all-reduce.
* :func:`qkv_heads` — a contiguous column shard of the fused q/k/v
  projection re-dealt to head-sharded q, k and v by three single-hop
  permutes (a bijection whenever ``gcd(3, n) == 1``).

The switch has three levels — the per-call argument, then
:func:`overlap_scope`, then ``PADDLE_TPU_MP_OVERLAP`` — and, PyTorch being
eager, is read at each call (JAX reads it once, at trace time).  Off, or
on a shape the ring cannot split, a wrapper returns ``None`` and the
caller keeps its monolithic path unchanged.  A wrapper runs over the
``group`` it is given (the ``_mp_group`` that ``parallelize`` or the
serving engine set on the model), else the global mesh's ``mp`` group,
and needs two ranks or more.

Where the JAX islands take global arrays under ``shard_map``, these take
the rank's shards: ``x`` cut on its last dimension for the row matmul,
``w`` the rank's rows or columns, ``wte`` its vocab rows.  The partial
matmuls are plain ``torch.matmul`` (an XLA-level schedule in JAX, no
Pallas kernel), and each ring keeps JAX's block schedule and summation
order: at ``n = 2`` every output is a two-term sum, equal to the
monolithic all-reduce's.  Each block can be split into ``chunks``
column sub-blocks permuted on their own, the knob of the ``mp_overlap``
autotune family.

The permutes are issued asynchronously before the partial matmul they
overlap and waited after it.  On NCCL the transfer then runs on NCCL's
stream beside the matmul; gloo stages every transfer through the host,
so over gloo the ring is correct but not faster.  :func:`qkv_heads`
moves data without autograd (the serving path).
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

from . import collective as _coll
from . import mesh as _mesh

MP_AXIS = "mp"
ENV_FLAG = "PADDLE_TPU_MP_OVERLAP"

_tls = threading.local()

__all__ = ["MP_AXIS", "ENV_FLAG", "env_enabled", "overlap_scope", "enabled",
           "scope_chunks", "active", "row_viable", "col_viable",
           "lm_viable", "qkv_viable", "embed_viable", "autotune_key",
           "row_parallel_matmul", "column_parallel_matmul", "lm_head_matmul",
           "vocab_embed", "qkv_heads"]


# ---------------------------------------------------------------------------
# the overlap switch: per-call arg > scope > env, read at each call
# ---------------------------------------------------------------------------

def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def env_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "").lower() in ("1", "true", "yes", "on")


@contextlib.contextmanager
def overlap_scope(enabled=True, chunks=None):
    """Pin the switch (and optionally the ring chunk count) for every
    call inside: the serving engine runs each step in this, so an engine
    built with ``overlap_comm=False`` stays monolithic even under
    ``PADDLE_TPU_MP_OVERLAP=1``."""
    _stack().append((bool(enabled), chunks))
    try:
        yield
    finally:
        _stack().pop()


def enabled(arg=None) -> bool:
    """The three-level switch: explicit arg > innermost scope > env.
    ``None`` inherits."""
    if arg is not None:
        return bool(arg)
    st = _stack()
    if st:
        return st[-1][0]
    return env_enabled()


def scope_chunks():
    st = _stack()
    return st[-1][1] if st else None


def active(arg=None, axis=MP_AXIS, group=None):
    """``(group, n)`` when an island runs at this call: the switch is on
    and ``group`` (else the global mesh's group of ``axis``) has a process
    group of ``n >= 2`` ranks.  ``None``: the caller keeps its monolithic
    path."""
    if not enabled(arg):
        return None
    if group is None:
        mesh = _mesh.get_mesh()
        group = mesh.group(axis) if mesh is not None else None
    if group is None or group.pg is None or group.nranks < 2:
        return None
    return group, int(group.nranks)


# -- viability (callers branch before they build the op, so the off or
# non-viable path is the monolithic one unchanged).  Dimensions are the
# GLOBAL ones, as in JAX ------------------------------------------------------

def row_viable(k_dim, arg=None, group=None):
    """Row matmul: the sharded contraction dim splits over the group."""
    act = active(arg, group=group)
    return act is not None and int(k_dim) % act[1] == 0


def col_viable(k_dim, n_dim, arg=None, group=None):
    """Column matmul: the sharded output dim splits; the backward ring
    also blocks the contraction dim over the group."""
    act = active(arg, group=group)
    return (act is not None and int(n_dim) % act[1] == 0
            and int(k_dim) % act[1] == 0)


def lm_viable(v_dim, arg=None, group=None):
    act = active(arg, group=group)
    return act is not None and int(v_dim) % act[1] == 0


def qkv_viable(num_heads, head_dim, arg=None, group=None):
    """The 3-permute re-deal needs gcd(3, n) == 1 and head-aligned
    shards (``num_heads % n == 0``)."""
    act = active(arg, group=group)
    if act is None:
        return False
    n = act[1]
    return n % 3 != 0 and int(num_heads) % n == 0


def embed_viable(vocab, arg=None, group=None):
    act = active(arg, group=group)
    return act is not None and int(vocab) % act[1] == 0


# ---------------------------------------------------------------------------
# chunk-count autotuning (the mp_overlap family) and the island counter
# ---------------------------------------------------------------------------

def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def autotune_key(kind, m, k, n, n_dev, dtype):
    """``kind`` names the ring (row / colbwd / lmhead); m/k/n are the
    GLOBAL matmul dims (m = flattened batch rows)."""
    from ..kernels import autotune as at
    return {"kind": str(kind), "m": int(m), "k": int(k), "n": int(n),
            "n_dev": int(n_dev), "dtype": _dtype_name(dtype),
            "platform": at.platform()}


def _candidates(key):
    """chunks=1 (one permute a ring step, the default) first; 2 and 4
    only where the permuted block splits evenly."""
    n_dev = max(1, int(key.get("n_dev", 1)))
    block = int(key.get("n", 0)) // n_dev
    out = [{"variant": "chunks1", "config": {"chunks": 1}}]
    for c in (2, 4):
        if block > 0 and block % c == 0:
            out.append({"variant": "chunks%d" % c, "config": {"chunks": c}})
    return out


def _tune_group(n_dev):
    """The group a tuning run times its ring over: the mesh's ``mp``
    group, or the world, of ``n_dev`` ranks."""
    import torch.distributed as dist
    mesh = _mesh.get_mesh()
    g = mesh.group(MP_AXIS) if mesh is not None else None
    if g is not None and g.pg is not None and g.nranks == n_dev:
        return g
    have = (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)
    if have != n_dev:
        raise RuntimeError("mp_overlap needs %d ranks, have %d"
                           % (n_dev, have))
    return _coll.Group(MP_AXIS, list(range(have)), dist.group.WORLD)


def _runner(cand, key):
    """Time the row ring at the key's shape over ``n_dev`` ranks (every
    rank of the group runs the same tune); fewer ranks raise."""
    from ..core.device import resolve_device
    from ..core.dtype import convert_dtype
    n_dev = int(key["n_dev"])
    group = _tune_group(n_dev)
    dev = resolve_device(None)
    dtype = convert_dtype(key["dtype"])
    m, k, n = int(key["m"]), int(key["k"]), int(key["n"])
    chunks = int(cand["config"]["chunks"])
    x = torch.ones((m, k // n_dev), dtype=dtype, device=dev)
    w = torch.ones((k // n_dev, n), dtype=dtype, device=dev)

    def run():
        blk = _ring_mm_rs(x, w, group, n_dev, chunks)
        _ring_ag(blk, group, n_dev, chunks)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    run()        # the first call outside the timed region
    return run


def _register():
    from ..kernels import autotune as at
    # a ring schedule, not a kernel: no shared-memory limit to price
    at.register_family("mp_overlap", _candidates, runner=_runner)


_register()


def _resolve_chunks(kind, m, k, n, n_dev, dtype, block):
    """Scope pin > autotune resolve (pin > memo > cache > tune > default
    chunks=1), clamped to a divisor of the permuted block."""
    c = scope_chunks()
    if c is None:
        from ..kernels import autotune as at
        cand = at.resolve("mp_overlap",
                          autotune_key(kind, m, k, n, n_dev, dtype))
        c = cand.get("config", {}).get("chunks", 1)
    c = max(1, int(c))
    while block % c:
        c -= 1
    _note_chunks(c)
    return c


def _note_chunks(chunks):
    """Drive the ``mp.overlap_chunks`` counter: one increment an island
    run, valued at its ring chunk count (JAX counts one an island traced;
    eager PyTorch runs the island at every call)."""
    from ..observability import registry as _reg
    _reg.counter("mp.overlap_chunks").inc(int(chunks))


def _rows(x):
    m = 1
    for d in x.shape[:-1]:
        m *= int(d)
    return m


# ---------------------------------------------------------------------------
# ring primitives (the *_l tensors are the rank's shards)
# ---------------------------------------------------------------------------

def _down(n):
    return [(s, (s - 1) % n) for s in range(n)]


def _up(n):
    return [(s, (s + 1) % n) for s in range(n)]


def _ring_mm_rs(x_l, w_l, group, n, chunks):
    """matmul then reduce-scatter as a ring.  ``x_l (..., K/n)``, ``w_l
    (K/n, N)``; returns this rank's reduced output block ``(..., N/n)``.
    At step t rank d computes its partial of block ``(d+t+1) mod n`` while
    the accumulator from d+1 is in flight (permute d -> d-1), then adds
    the arrival and the partial in JAX's order."""
    idx = group.rank
    nb = w_l.shape[-1] // n
    sub = nb // chunks

    def piece(i, j):
        c0 = i * nb + j * sub
        return w_l[:, c0:c0 + sub]

    accs = [x_l @ piece((idx + 1) % n, j) for j in range(chunks)]
    for t in range(1, n):
        flight = [_coll.ppermute(a, _down(n), group, async_op=True)
                  for a in accs]
        parts = [x_l @ piece((idx + t + 1) % n, j) for j in range(chunks)]
        accs = [f.wait() + p for f, p in zip(flight, parts)]
    return accs[0] if chunks == 1 else torch.cat(accs, dim=-1)


def _ring_ag(y_blk, group, n, chunks):
    """Ring all-gather of the ranks' blocks along the last dim: after t
    permutes (d -> d+1) the resident block is ``(d-t) mod n``; each lands
    in its slice of the full output while the next is in flight."""
    idx = group.rank
    nb = y_blk.shape[-1]
    sub = nb // chunks
    out = y_blk.new_empty(tuple(y_blk.shape[:-1]) + (nb * n,))
    cur = [y_blk] if chunks == 1 else list(torch.split(y_blk, sub, dim=-1))
    for t in range(n):
        blk = (idx - t) % n
        flight = ([_coll.ppermute(p, _up(n), group, async_op=True)
                   for p in cur] if t + 1 < n else None)
        for j, p in enumerate(cur):
            c0 = blk * nb + j * sub
            out[..., c0:c0 + sub] = p
        if flight is not None:
            cur = [f.wait() for f in flight]
    return out


def _ring_lm(x, w_l, group, n, chunks):
    """Rotate-weights all-gather then matmul for the LM head: ``x`` the
    full ``(..., H)`` activation, ``w_l (V/n, H)`` the resident vocab
    shard; after t permutes (d -> d+1) the resident shard is vocab block
    ``(d-t) mod n``, matmulled into its logits slice while the next shard
    is in flight."""
    idx = group.rank
    vb = w_l.shape[0]
    sub = vb // chunks
    out = x.new_empty(tuple(x.shape[:-1]) + (vb * n,))
    cur = [w_l] if chunks == 1 else list(torch.split(w_l, sub, dim=0))
    for t in range(n):
        blk = (idx - t) % n
        flight = ([_coll.ppermute(p, _up(n), group, async_op=True)
                   for p in cur] if t + 1 < n else None)
        for j, p in enumerate(cur):
            c0 = blk * vb + j * sub
            out[..., c0:c0 + sub] = x @ p.t()
        if flight is not None:
            cur = [f.wait() for f in flight]
    return out


def _fold(t):
    return t.reshape(-1, t.shape[-1])


# ---------------------------------------------------------------------------
# row-parallel matmul: ring RS+AG forward, collective-free backward
# ---------------------------------------------------------------------------

class _RowMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_l, w_l, group, n, chunks):
        ctx.save_for_backward(x_l, w_l)
        return _ring_ag(_ring_mm_rs(x_l, w_l, group, n, chunks), group, n,
                        chunks)

    @staticmethod
    def backward(ctx, dy):
        # the row forward's all-reduce transposes to the identity: both
        # cotangents are shard-local matmuls
        x_l, w_l = ctx.saved_tensors
        dx = dy @ w_l.t()
        dw = _fold(x_l).t() @ _fold(dy)
        return dx, dw, None, None, None


def row_parallel_matmul(x, w, bias=None, arg=None, group=None):
    """Overlapped ``x @ w`` with ``w (K/n, N)`` the rank's rows of the
    contraction dim and ``x (..., K/n)`` its columns: the monolithic
    matmul then all-reduce becomes the ring.  Returns the full ``(...,
    N)`` output (+ ``bias``, replicated), or ``None`` when the switch is
    off or no group of two ranks is there: the caller keeps its
    monolithic path."""
    act = active(arg, group=group)
    if act is None:
        return None
    g, n = act
    k, nn = int(w.shape[0]) * n, int(w.shape[1])
    if nn % n:
        return None
    chunks = _resolve_chunks("row", _rows(x), k, nn, n, x.dtype,
                             max(nn // n, 1))
    out = _RowMatmul.apply(x, w, g, n, chunks)
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# column-parallel matmul: local forward, ring backward
# ---------------------------------------------------------------------------

class _ColMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_l, group, n, chunks):
        ctx.save_for_backward(x, w_l)
        ctx.ring = (group, n, chunks)
        return x @ w_l

    @staticmethod
    def backward(ctx, dy_l):
        # dx = dy @ w.T contracts over the SHARDED output dim: the row
        # forward's ring with a_l = dy_l (..., N/n), b_l = w_l.T (N/n, K)
        x, w_l = ctx.saved_tensors
        group, n, chunks = ctx.ring
        dx = _ring_ag(_ring_mm_rs(dy_l, w_l.t(), group, n, chunks), group,
                      n, chunks)
        dw = _fold(x).t() @ _fold(dy_l)
        return dx, dw, None, None, None


def column_parallel_matmul(x, w, bias=None, arg=None, group=None):
    """Overlapped ``x @ w`` with ``w (K, N/n)`` the rank's columns: the
    forward is the local matmul, and the backward runs dx's all-reduce
    through the ring.  The output stays the rank's ``(..., N/n)`` columns
    (+ the rank's piece of ``bias``).  ``None``: switch off."""
    act = active(arg, group=group)
    if act is None:
        return None
    g, n = act
    k, nn = int(w.shape[0]), int(w.shape[1]) * n
    if k % n:
        return None
    chunks = _resolve_chunks("colbwd", _rows(x), nn, k, n, x.dtype,
                             max(k // n, 1))
    out = _ColMatmul.apply(x, w, g, n, chunks)
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# LM head: rotate-weights ring over the vocab shards
# ---------------------------------------------------------------------------

class _LMMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_l, group, n, chunks):
        ctx.save_for_backward(x, w_l)
        ctx.group = group
        return _ring_lm(x, w_l, group, n, chunks)

    @staticmethod
    def backward(ctx, dy):
        # dx contracts over the sharded vocab dim: the shard's partial and
        # one all-reduce; dw is shard-local
        x, w_l = ctx.saved_tensors
        g = ctx.group
        vb = int(w_l.shape[0])
        dy_l = dy[..., g.rank * vb:(g.rank + 1) * vb]
        dx = _coll.all_reduce(dy_l @ w_l, group=g)
        dw = _fold(dy_l).t() @ _fold(x)
        return dx, dw, None, None, None


def lm_head_matmul(x, wte, arg=None, group=None):
    """Overlapped ``x @ wte.T`` with ``wte (V/n, H)`` the rank's vocab
    rows: the rotate-weights ring in place of the table's all-gather.
    The full ``(..., V)`` logits come back on every rank.  ``None``:
    switch off."""
    act = active(arg, group=group)
    if act is None:
        return None
    g, n = act
    v, h = int(wte.shape[0]) * n, int(wte.shape[1])
    chunks = _resolve_chunks("lmhead", _rows(x), h, v, n, x.dtype,
                             max(v // n, 1))
    return _LMMatmul.apply(x, wte, g, n, chunks)


# ---------------------------------------------------------------------------
# vocab-parallel embedding: masked local gather + one all-reduce
# ---------------------------------------------------------------------------

def vocab_embed(ids, wte, arg=None, group=None):
    """Lookup in the rank's vocab rows ``wte (V/n, H)`` without the table:
    ids outside the shard give zeros, and the rows meet in one all-reduce
    of activation bytes.  ``None``: switch off.  (The port's monolithic
    vocab-parallel lookup, :func:`.mp_layers.vocab_parallel_embedding`,
    is this schedule already: JAX's monolithic one all-gathers the
    table.)"""
    act = active(arg, group=group)
    if act is None:
        return None
    from .mp_layers import vocab_parallel_embedding
    return vocab_parallel_embedding(ids, wte, act[0])


# ---------------------------------------------------------------------------
# fused-qkv projection + 3-permute head re-deal (the serving path)
# ---------------------------------------------------------------------------

def qkv_heads(x, w, b, num_heads, head_dim, arg=None, group=None):
    """The fused column q/k/v projection straight into the head-sharded
    layout.

    ``x (B, S, E)`` replicated, ``w (E, 3H/n)`` the rank's CONTIGUOUS
    column shard of the fused (E, 3H) weight, ``b`` its piece of the bias
    or None -> ``(q, k, v)``, each ``(B, S, heads/n, head_dim)``: the
    rank's heads.  In units of ``Hb = H/n`` rank ``s`` holds global blocks
    ``3s, 3s+1, 3s+2`` and rank ``d`` needs blocks ``d, n+d, 2n+d``; for
    ``gcd(3, n) == 1`` each local slot ``l`` maps by the bijection ``s ->
    (3s+l) mod n``, so three single-hop permutes re-deal everything, and
    the receiver takes q/k/v from slot ``(n j + d) mod 3``.  ``None`` when
    the switch is off, ``n % 3 == 0`` or the shapes do not divide.  (The
    port's ``parallelize`` deals the fused weight by heads already, so
    its GPT model needs no re-deal: there the island is the local
    projection.)"""
    act = active(arg, group=group)
    if act is None:
        return None
    g, n = act
    if n % 3 == 0:
        return None
    h = num_heads * head_dim
    if int(w.shape[1]) * n != 3 * h or h % n or num_heads % n:
        return None
    hb = h // n
    heads_l = num_heads // n
    _note_chunks(1)   # a single-hop deal: no chunk knob, still an island
    qkv = x @ w if b is None else x @ w + b
    flight = [_coll.ppermute(qkv[..., l * hb:(l + 1) * hb],
                             [(s, (3 * s + l) % n) for s in range(n)], g,
                             async_op=True) for l in range(3)]
    recv = [f.wait() for f in flight]
    d = g.rank
    return tuple(recv[(n * j + d) % 3].reshape(
        tuple(qkv.shape[:-1]) + (heads_l, head_dim)) for j in range(3))
