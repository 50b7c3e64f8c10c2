"""Hard-label cross entropy: the CUDA kernels ``csrc/cross_entropy.cu``
(E1 logsumexp, E2 fused softmax-CE forward, E3 its backward), their plain
PyTorch versions and the autograd Functions that join them (port of
``paddle_tpu/kernels/ce_pallas.py``: ``_lse_kernel``, ``_fwd_kernel`` /
``_bwd_kernel`` through ``logsumexp_pallas`` and ``softmax_ce_pallas``
and their ``custom_vjp``s).

Logits are (N, V) in float32, bfloat16 or float16, dense, V a multiple of
128; labels (N, 1) int32 already clipped to [0, V).  Row statistics are
f32 and every lse is in base e.  The route predicates :func:`supported`
and :func:`lse_supported` are copies of the JAX package's, so both
packages send the same shapes to their kernels.

A CUDA tensor launches the kernels (or raises); only a CPU tensor takes
the plain versions :func:`softmax_ce_reference`,
:func:`softmax_ce_bwd_reference` and :func:`logsumexp_reference`.
``ce_lse_launches``, ``ce_fwd_launches`` and ``ce_bwd_launches`` count
kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

#: kernel launches since import (or since a caller reset them)
ce_lse_launches = 0
ce_fwd_launches = 0
ce_bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

DEFAULT_BLOCK_ROWS = 8


# -- route predicates: copies of ce_pallas.py ------------------------------
def supported(n_rows: int, vocab: int, block_rows: int = DEFAULT_BLOCK_ROWS):
    """Tileability + VMEM budget for the resident (R, V) tile: the bf16
    tile is double-buffered and the kernel's f32 elementwise chain
    materialises ~3 tile-sized temporaries in VMEM."""
    if n_rows <= 0 or vocab % 128 or n_rows % 8:
        return False
    br = _row_block(n_rows)
    if n_rows % br:
        return False
    return br * vocab * (2 * 2 + 4 * 3) <= 10 * 1024 * 1024


def _row_block(n):
    br = min(DEFAULT_BLOCK_ROWS, max(n, 1))
    while br > 8 and n % br:
        br //= 2
    return br


def _lse_chunk(v: int, br: int, itemsize: int) -> int:
    # largest lane-aligned divisor of v whose input tile (double-buffered
    # at the logits' own itemsize) plus the kernel's ~2 f32 tile
    # temporaries fits the VMEM budget
    budget = 10 * 1024 * 1024
    best = 0
    for c in range(128, v + 1, 128):
        if v % c == 0 and br * c * (2 * itemsize + 4 * 2) <= budget:
            best = c
    return best


def _lse_layout(n: int, v: int, itemsize: int = 2):
    """Joint (row_block, chunk) pick: the largest row block whose
    admissible chunk is still >= 1024 lanes; (0, 0) where none is."""
    for br in (256, 128, 64, 32, 16, 8):
        if n % br:
            continue
        c = _lse_chunk(v, br, itemsize)
        if c >= 1024:
            return br, c
    return 0, 0


def lse_supported(n_rows: int, vocab: int, itemsize: int = 2) -> bool:
    if n_rows <= 0 or vocab % 128:
        return False
    return _lse_layout(n_rows, vocab, itemsize)[0] > 0


# -- plain versions ---------------------------------------------------------
def logsumexp_reference(logits2):
    """Base-e logsumexp of each row of (N, V) logits: (N,) f32."""
    xf = logits2.float()
    m = xf.amax(dim=-1)
    return m + torch.log(torch.exp(xf - m[:, None]).sum(-1))


def softmax_ce_reference(logits2, labels2):
    """(nll (N,), lse (N,)), both f32: nll = lse - logits[i, y_i]."""
    lse = logsumexp_reference(logits2)
    t = torch.gather(logits2, 1, labels2.long()).float()[:, 0]
    return lse - t, lse


def softmax_ce_bwd_reference(logits2, labels2, lse, g):
    """dlogits = (exp(x - lse) - onehot(y)) * g in the logits' dtype, f32
    arithmetic; ``lse`` and ``g`` are (N,) f32."""
    p = torch.exp(logits2.float() - lse[:, None])
    onehot = torch.zeros_like(p).scatter_(1, labels2.long(), 1.0)
    return ((p - onehot) * g[:, None]).to(logits2.dtype)


# -- the kernels' wrappers --------------------------------------------------
def _check(what, x, labels=None):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("%s: logits must be a 2-D (N, V) tensor" % what)
    if x.dtype not in _DTYPES:
        raise TypeError("%s: logits dtype %s not supported (float32, "
                        "bfloat16 or float16)" % (what, x.dtype))
    if not x.is_contiguous():
        raise ValueError("%s: logits must be contiguous" % what)
    n, v = x.shape
    if n == 0 or v % 128:
        raise ValueError("%s: (N, V) = (%d, %d): need N > 0 and V a "
                         "multiple of 128" % (what, n, v))
    if labels is not None:
        if labels.shape != (n, 1) or labels.dtype != torch.int32 or \
                labels.device != x.device:
            raise ValueError("%s: labels must be (%d, 1) int32 on %s, got "
                             "%s %s on %s" % (what, n, x.device,
                                              tuple(labels.shape),
                                              labels.dtype, labels.device))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (what, x.device))
    if x.is_cuda and x.data_ptr() % 16:
        raise ValueError("%s: logits must be 16-byte aligned" % what)


def _rows(n, like):
    return torch.empty((n,), dtype=torch.float32, device=like.device)


def lse_fwd(logits2):
    """E1: (N,) f32 base-e logsumexp of each row."""
    global ce_lse_launches
    _check("ce_lse", logits2)
    if not logits2.is_cuda:
        return logsumexp_reference(logits2)
    n, v = logits2.shape
    lse = _rows(n, logits2)
    _build.check(_build.library().paddle_ce_lse(
        logits2.data_ptr(), lse.data_ptr(), n, v, _DTYPES[logits2.dtype],
        _build.current_stream(logits2.device)), "ce_lse launch")
    ce_lse_launches += 1
    return lse


def ce_fwd(logits2, labels2):
    """E2: (nll (N,), lse (N,)), both f32."""
    global ce_fwd_launches
    _check("ce_fwd", logits2, labels2)
    if not logits2.is_cuda:
        return softmax_ce_reference(logits2, labels2)
    n, v = logits2.shape
    nll, lse = _rows(n, logits2), _rows(n, logits2)
    _build.check(_build.library().paddle_ce_fwd(
        logits2.data_ptr(), labels2.contiguous().data_ptr(), nll.data_ptr(),
        lse.data_ptr(), n, v, _DTYPES[logits2.dtype],
        _build.current_stream(logits2.device)), "ce_fwd launch")
    ce_fwd_launches += 1
    return nll, lse


def ce_bwd(logits2, labels2, lse, g):
    """E3: dlogits (N, V) in the logits' dtype from the forward's f32
    ``lse`` (N,) and the f32 cotangent ``g`` (N,)."""
    global ce_bwd_launches
    _check("ce_bwd", logits2, labels2)
    n, v = logits2.shape
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (n,) or t.dtype != torch.float32 or \
                t.device != logits2.device:
            raise ValueError("ce_bwd: %s must be (%d,) float32 on %s"
                             % (name, n, logits2.device))
    if not logits2.is_cuda:
        return softmax_ce_bwd_reference(logits2, labels2, lse, g)
    dx = torch.empty_like(logits2)
    _build.check(_build.library().paddle_ce_bwd(
        logits2.data_ptr(), labels2.contiguous().data_ptr(),
        lse.contiguous().data_ptr(), g.contiguous().data_ptr(),
        dx.data_ptr(), n, v, _DTYPES[logits2.dtype],
        _build.current_stream(logits2.device)), "ce_bwd launch")
    ce_bwd_launches += 1
    return dx


class _SoftmaxCE(torch.autograd.Function):
    """nll = softmax_ce(logits2, labels2); saves (logits, labels, lse) as
    the JAX ``_vjp_fwd`` does and differentiates through :func:`ce_bwd`
    with the cotangent upcast to f32."""

    @staticmethod
    def forward(ctx, logits2, labels2):
        nll, lse = ce_fwd(logits2, labels2)
        ctx.save_for_backward(logits2, labels2, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits2, labels2, lse = ctx.saved_tensors
        return ce_bwd(logits2, labels2, lse, g.float().contiguous()), None


class _LogSumExp(torch.autograd.Function):
    """lse = logsumexp(logits2); saves (logits, lse).  Its backward is the
    JAX package's plain pullback, outside any kernel there as here."""

    @staticmethod
    def forward(ctx, logits2):
        lse = lse_fwd(logits2)
        ctx.save_for_backward(logits2, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits2, lse = ctx.saved_tensors
        return (torch.exp(logits2.float() - lse[:, None])
                * g[:, None]).to(logits2.dtype)


def _needs_grad(x):
    return torch.is_grad_enabled() and x.requires_grad


def softmax_ce(logits2, labels2):
    """logits2 (N, V), labels2 (N, 1) int32 pre-clipped to [0, V) ->
    per-row nll (N,) f32; differentiable in the logits."""
    if _needs_grad(logits2):
        return _SoftmaxCE.apply(logits2, labels2)
    return ce_fwd(logits2, labels2)[0]


def logsumexp(logits2):
    """One-pass logsumexp over the last axis of (N, V) logits: (N,) f32 in
    base e; differentiable."""
    if _needs_grad(logits2):
        return _LogSumExp.apply(logits2)
    return lse_fwd(logits2)
