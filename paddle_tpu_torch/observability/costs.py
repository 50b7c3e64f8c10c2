"""Step cost and memory reports (port of
``paddle_tpu/observability/costs.py``): the ``cost`` block a bench line
carries (``flops``, ``hbm_bytes``, ``peak_bytes``, ``mfu``,
``bw_util``), and the peaks it is measured against.

The JAX package reads XLA's ``cost_analysis()`` of a compiled program.
The port has no compiled program, so :func:`report_step` runs the step
once and counts:

* **flops** — the aten ops the step dispatches, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  convolutions: the ops it has formulas for; elementwise work counts 0),
  plus the work of each function a hand-written kernel computes,
  declared from its shapes by the function that routes to the kernel.
  The CUDA kernels are ``ctypes`` calls the counter never sees, and a
  plain version computes its function another way (the plain attention
  forms the whole S x S product, which the causal kernel halves), so
  those routing points run their body through :func:`counted`: the body
  (kernel or plain version, forward and backward) is hidden from the
  counter, and the function's work is added once, the same whichever
  implementation runs:

  - attention (``nn.functional.scaled_dot_product_attention``, whose
    flash route is ``kernels/flash_attention.py``): forward two products
    over the visible (query, key) pairs, ``4 B H D pairs``; backward five
    (S recomputed, dP, dV, dQ, dK — the merged kernel C1's),
    ``10 B H D pairs``; ``pairs`` is ``S (S + 1) / 2`` causal, else
    ``S_q S_k`` (PERF.md §6's bounds count the same);
  - LayerNorm (``nn.functional.layer_norm``, kernels B and D): ``8`` a
    normalized element forward, ``12`` backward;
  - hard-label softmax cross entropy (kernels E1-E3): ``5`` a logit
    forward, ``5`` backward.

  The optimizer's update is elementwise and counts 0, as the grad clip
  does.  The count is of one step, with no compile or warm-up in it.
* **peak_bytes** — ``torch.cuda.max_memory_allocated`` across the step
  on a card, ``None`` on the CPU.
* **hbm_bytes** — ``None``: no count of the bytes each op moves is made
  the same way for every op, and JAX's contract is that a missing field
  is ``None``, never a guess.

:func:`peak_flops` and :func:`peak_hbm_bandwidth` are keyed on
``torch.cuda.get_device_name()``; the table holds the H100 SXM's
published dense peaks only (bf16 989e12 FLOP/s, 3.35e12 B/s), and
``PADDLE_TPU_PEAK_FLOPS`` / ``PADDLE_TPU_PEAK_HBM_BW`` override it.
:func:`cost_block` derives ``mfu = flops / (step_seconds * peak)`` from a
step time the caller measured (the profiler's device seconds of a step,
say).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Sequence

import torch

__all__ = [
    "ProgramReport", "peak_flops", "peak_hbm_bandwidth", "mfu", "bw_util",
    "cost_block", "format_table", "counting", "counting_active", "counted",
    "report_step",
    "attention_flops", "layer_norm_flops", "cross_entropy_flops",
]

# ---------------------------------------------------------------------------
# per-part peak specs (published numbers, per card); substring-matched
# against the lowercased device name.  Overridable via
# PADDLE_TPU_PEAK_FLOPS / PADDLE_TPU_PEAK_HBM_BW (floats, per card).
# ---------------------------------------------------------------------------

#: dense bf16 peak FLOP/s per card by device-name substring (lowercase):
#: the H100 SXM ("NVIDIA H100 80GB HBM3")
PEAK_FLOPS_BY_KIND = (("h100 80gb hbm3", 989e12), ("h100 sxm", 989e12))

#: HBM bandwidth bytes/s per card by device-name substring (lowercase)
PEAK_HBM_BW_BY_KIND = (("h100 80gb hbm3", 3.35e12), ("h100 sxm", 3.35e12))


def _kind_lookup(table, kind: Optional[str]) -> Optional[float]:
    if not kind:
        return None
    kind = kind.lower()
    for sub, v in table:
        if sub in kind:
            return v
    return None


def _device_kind() -> Optional[str]:
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def peak_flops(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one card (None off a card / unknown
    part)."""
    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    return _kind_lookup(PEAK_FLOPS_BY_KIND, device_kind or _device_kind())


def peak_hbm_bandwidth(device_kind: Optional[str] = None
                       ) -> Optional[float]:
    """Peak HBM bytes/s of one card (None off a card / unknown part)."""
    env = os.environ.get("PADDLE_TPU_PEAK_HBM_BW")
    if env:
        return float(env)
    return _kind_lookup(PEAK_HBM_BW_BY_KIND, device_kind or _device_kind())


def mfu(flops: Optional[float], step_seconds: Optional[float],
        device_kind: Optional[str] = None) -> Optional[float]:
    """Model FLOPs utilization of one step: step FLOPs / (step seconds *
    card peak).  None whenever any input is unknown — a fabricated 0.0
    would enter the trajectory as a datum."""
    peak = peak_flops(device_kind)
    if not flops or not step_seconds or step_seconds <= 0 or not peak:
        return None
    return flops / (step_seconds * peak)


def bw_util(hbm_bytes: Optional[float], step_seconds: Optional[float],
            device_kind: Optional[str] = None) -> Optional[float]:
    """HBM bandwidth utilization: step bytes / (step seconds * card peak
    bandwidth)."""
    peak = peak_hbm_bandwidth(device_kind)
    if not hbm_bytes or not step_seconds or step_seconds <= 0 or not peak:
        return None
    return hbm_bytes / (step_seconds * peak)


@dataclasses.dataclass
class ProgramReport:
    """The cost and memory view of one step, in the JAX report's field
    names where the port measures the same thing; ``bytes_accessed`` (the
    JAX report's HBM bytes) stays ``None``.  ``flops`` is
    ``counted_flops`` (the aten ops the counter saw) plus
    ``declared_flops`` (the kernel-routed functions' work)."""

    name: str
    backend: str = ""
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    peak_bytes: Optional[int] = None
    counted_flops: Optional[float] = None
    declared_flops: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

#: the count in progress (one at a time), read by :func:`counted`
_COUNT: Optional["_Count"] = None


class _Count:
    """A ``FlopCounterMode`` plus the declared work and the counted ops
    hidden from it."""

    def __init__(self, mode):
        self.mode = mode
        self.declared = 0
        self.hidden = 0

    @contextlib.contextmanager
    def hiding(self):
        before = self.mode.get_total_flops()
        try:
            yield
        finally:
            self.hidden += self.mode.get_total_flops() - before

    @property
    def counted(self) -> int:
        return self.mode.get_total_flops() - self.hidden

    @property
    def total(self) -> int:
        return self.counted + self.declared


@contextlib.contextmanager
def counting():
    """Count the work of what runs in the block (this thread's dispatch
    and the autograd it starts); yields the :class:`_Count`."""
    global _COUNT
    from torch.utils.flop_counter import FlopCounterMode
    if _COUNT is not None:
        raise RuntimeError("a cost count is already running")
    c = _Count(FlopCounterMode(display=False))
    with c.mode:
        _COUNT = c
        try:
            yield c
        finally:
            _COUNT = None


class _Counted(torch.autograd.Function):
    """Runs ``fn`` on fresh leaves with the counter hidden, declares the
    forward's work, and in the backward the backward's work while the
    inner graph's backward runs hidden too."""

    @staticmethod
    def forward(ctx, fn, count, fwd_flops, bwd_flops, *inputs):
        ctx.count, ctx.bwd_flops, ctx.n = count, bwd_flops, len(inputs)
        count.declared += fwd_flops
        leaves = [x.detach().requires_grad_(x.requires_grad)
                  if isinstance(x, torch.Tensor) else x for x in inputs]
        ctx.diff = [i for i, x in enumerate(leaves)
                    if isinstance(x, torch.Tensor) and x.requires_grad]
        with torch.enable_grad(), count.hiding():
            out = fn(*leaves)
        ctx.out = out
        ctx.leaves = [leaves[i] for i in ctx.diff]
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        count = ctx.count
        count.declared += ctx.bwd_flops
        with count.hiding():
            grads = torch.autograd.grad(ctx.out, ctx.leaves, grad,
                                        allow_unused=True)
        ctx.out = ctx.leaves = None
        res = [None] * ctx.n
        for i, g in zip(ctx.diff, grads):
            res[i] = g
        return (None, None, None, None, *res)


def counting_active() -> bool:
    """Whether a :func:`counting` block is running (the routing points'
    one module-global check)."""
    return _COUNT is not None


def counted(fn: Callable, inputs: Sequence, fwd_flops: int,
            bwd_flops: int):
    """``fn(*inputs)`` (one tensor out).  While :func:`counting` runs, the
    body's ops are hidden from the counter and ``fwd_flops`` (and, when
    the backward runs, ``bwd_flops``) are declared in their place;
    otherwise it is the plain call (one module-global ``None`` check)."""
    c = _COUNT
    if c is None:
        return fn(*inputs)
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in inputs):
        return _Counted.apply(fn, c, int(fwd_flops), int(bwd_flops),
                              *inputs)
    c.declared += int(fwd_flops)
    with c.hiding():
        return fn(*inputs)


def attention_flops(b, h, d, s_q, s_k, causal):
    """(forward, backward) work of attention over (B, S, H, D): two
    products over the visible pairs forward, five backward."""
    pairs = s_q * (s_q + 1) // 2 if causal and s_q == s_k else s_q * s_k
    return 4 * b * h * d * pairs, 10 * b * h * d * pairs


def layer_norm_flops(n_elems):
    """(forward, backward) work of a LayerNorm over ``n_elems``."""
    return 8 * n_elems, 12 * n_elems


def cross_entropy_flops(n_logits):
    """(forward, backward) work of a hard-label softmax CE."""
    return 5 * n_logits, 5 * n_logits


def report_step(name: str, run: Callable, device=None) -> ProgramReport:
    """Run ``run()`` (one step) under :func:`counting`, on a card with
    the allocator's peak reset first, and report it."""
    dev = torch.device(device) if device is not None else None
    on_card = dev is not None and dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with counting() as c:
        run()
    peak = None
    if on_card:
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
    return ProgramReport(
        name=name, backend=dev.type if dev is not None else "",
        flops=float(c.total), peak_bytes=peak,
        counted_flops=float(c.counted), declared_flops=float(c.declared))


# ---------------------------------------------------------------------------
# the bench `cost` block
# ---------------------------------------------------------------------------

def cost_block(report: ProgramReport,
               step_seconds: Optional[float] = None,
               on_chip: Optional[bool] = None,
               device_kind: Optional[str] = None) -> Dict[str, Any]:
    """The ``cost`` block of a bench line: the static fields (None where
    not measured) and ``mfu`` / ``bw_util`` from ``step_seconds`` where
    the step ran on a card (``on_chip`` defaults to the report's
    backend being ``"cuda"``)."""
    if on_chip is None:
        on_chip = report.backend == "cuda"
    use_t = step_seconds if on_chip else None
    m = mfu(report.flops, use_t, device_kind)
    b = bw_util(report.bytes_accessed, use_t, device_kind)
    return {
        "flops": report.flops,
        "hbm_bytes": report.bytes_accessed,
        "peak_bytes": report.peak_bytes,
        "mfu": (round(m, 6) if m is not None else None),
        "bw_util": (round(b, 6) if b is not None else None),
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _fmt_num(v: Optional[float]) -> str:
    if v is None:
        return "-"
    v = float(v)
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= div:
            return "%.2f%s" % (v / div, unit)
    return "%.0f" % v


def format_table(reports: Sequence[ProgramReport]) -> str:
    """Human table of reports: flops (counted + declared), peak bytes."""
    lines = ["%-42s %10s %10s %10s %10s  %s"
             % ("program", "flops", "counted", "declared", "peak",
                "backend")]
    for r in reports:
        lines.append("%-42s %10s %10s %10s %10s  %s"
                     % (r.name, _fmt_num(r.flops), _fmt_num(r.counted_flops),
                        _fmt_num(r.declared_flops), _fmt_num(r.peak_bytes),
                        r.backend or "-"))
    lines.append("%d program(s)" % len(reports))
    return "\n".join(lines)
