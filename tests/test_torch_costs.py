"""paddle_tpu_torch.observability.costs on the CPU: ``TrainStep.cost_report``
of the tiny GPT equals a closed-form count exactly, on the plain routes and
with the kernel routes patched in (flash attention, the LayerNorm and
cross-entropy kernels, each taking its plain version on the CPU), leaves
the step's state as it was, and stands in a measured ratio to the JAX
step's XLA count; the peak table, ``mfu`` and ``cost_block``;
``DecodeEngine.cost_reports``."""
import numpy as np
import pytest
import torch

import _torch_guard as G
from _torch_threads import one_thread  # noqa: F401  (autouse)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn.functional import loss as loss_mod
from paddle_tpu_torch.observability import costs
from paddle_tpu_torch.utils import flags


def _closed_form(cfg, b, s):
    """One step's work: the linears and the tied head forward, their two
    backward products (dX, dW) each; causal attention (2 products over the
    visible pairs forward, 5 backward); 2L + 1 LayerNorms (8 + 12 a
    normalized element); the softmax CE (5 + 5 a logit)."""
    h, v, L, i = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers, \
        cfg.intermediate_size
    heads = cfg.num_attention_heads
    t = b * s
    dense = L * 2 * t * h * (3 * h + h + 2 * i) + 2 * t * h * v
    pairs = s * (s + 1) // 2
    attn = L * (4 + 10) * b * heads * (h // heads) * pairs
    norms = (2 * L + 1) * (8 + 12) * t * h
    ce = (5 + 5) * t * v
    return 3 * dense, attn + norms + ce


def _kernel_routes(monkeypatch):
    """Every kernel route taken on the CPU: the flash gate, the LayerNorm
    flag (hidden 128 passes its width gate) and the fused CE's gate."""
    monkeypatch.setattr(fa, "supported", lambda q, k=None: True)
    flags.set_flags({"use_pallas_norm": True, "use_pallas_ce": True})

    def gate(flag_name, logits):
        n = int(np.prod(logits.shape[:-1]))
        return n, logits.shape[-1], tuple(logits.shape[:-1])
    monkeypatch.setattr(loss_mod, "_pallas_ce_gate", gate)


def _wide_step(seed=0):
    cfg = GPTConfig(vocab_size=512, max_position_embeddings=128,
                    hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    m = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(seed))
    return G.TrainStep(m, G.GPTPretrainingCriterion(), G.port_opt(m),
                       device="cpu")


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_cost_report_equals_the_closed_form(route, monkeypatch):
    try:
        if route == "kernels":
            _kernel_routes(monkeypatch)
        step = _wide_step()
        # S = 64: the flash kernels' block
        batch = G.port_batch(G.batches(1, b=2, s=64)[0])
        rep = step.cost_report(batch)
    finally:
        flags.set_flags({"use_pallas_norm": False, "use_pallas_ce": False})
    counted, declared = _closed_form(step.model.config, 2, 64)
    assert rep.counted_flops == counted
    assert rep.declared_flops == declared
    assert rep.flops == counted + declared
    assert rep.peak_bytes is None and rep.bytes_accessed is None
    assert rep.backend == "cpu" and rep.name == "jit.train_step"


def test_both_routes_launch_their_kernels_paths(monkeypatch):
    """The patched kernel route really runs the kernel wrappers' plain
    versions (the flop count holds them hidden)."""
    from paddle_tpu_torch.kernels import flash_attention_cuda as fac
    from paddle_tpu_torch.kernels import norm_cuda
    calls = {"flash": 0, "ln": 0}
    orig_fa, orig_ln = fac.flash_attention_bshd, norm_cuda.layer_norm

    def fa_spy(*a, **k):
        calls["flash"] += 1
        return orig_fa(*a, **k)

    def ln_spy(*a, **k):
        calls["ln"] += 1
        return orig_ln(*a, **k)
    monkeypatch.setattr(fac, "flash_attention_bshd", fa_spy)
    monkeypatch.setattr(norm_cuda, "layer_norm", ln_spy)
    try:
        _kernel_routes(monkeypatch)
        step = _wide_step()
        step.cost_report(G.port_batch(G.batches(1, b=2, s=64)[0]))
    finally:
        flags.set_flags({"use_pallas_norm": False, "use_pallas_ce": False})
    assert calls == {"flash": 2, "ln": 5}


def test_cost_report_changes_no_state():
    """A cost report between two steps leaves the trajectory bit for bit
    (dropout 0.1: the generators are restored too)."""
    data = [G.port_batch(b) for b in G.batches(3)]

    def run(report):
        _jm, tm = G.models(dropout=0.1)
        step = G.TrainStep(tm, G.GPTPretrainingCriterion(), G.port_opt(tm),
                           device="cpu")
        out = [float(step(*data[0]))]
        if report:
            step.cost_report(data[1])
        out += [float(step(*b)) for b in data[1:]]
        return out
    assert run(True) == run(False)


def test_ratio_to_the_jax_step_count():
    """The JAX step's count is XLA's cost analysis of its compiled step on
    the CPU: it also counts every elementwise op (GELU, softmax, the
    LayerNorms, AdamW's update) and the full S x S attention products that
    the causal kernel halves, and not the backward's recompute of S.  On
    the tiny GPT at (2, 16) the port's count is 0.8663 of JAX's."""
    jstep, tstep = G.steps()
    b = G.batches(1)[0]
    jax_flops = jstep.cost_report(G.jax_batch(b)).flops
    rep = tstep.cost_report(G.port_batch(b))
    counted, declared = _closed_form(tstep.model.config, 2, 16)
    assert rep.flops == counted + declared
    assert 0.86 < rep.flops / jax_flops < 0.87


def test_peaks_mfu_and_cost_block(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PEAK_HBM_BW", raising=False)
    assert costs.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert costs.peak_hbm_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    for other in ("NVIDIA H100 PCIe", "TPU v5 lite", "TPU v4"):
        assert costs.peak_flops(other) is None
    rep = costs.ProgramReport(name="x", backend="cuda", flops=1e12,
                              peak_bytes=123)
    block = costs.cost_block(rep, 0.01, device_kind="NVIDIA H100 80GB HBM3")
    assert block == {"flops": 1e12, "hbm_bytes": None, "peak_bytes": 123,
                     "mfu": round(1e12 / (0.01 * 989e12), 6),
                     "bw_util": None}
    # a CPU report carries no utilization; an override peak is used as is
    assert costs.cost_block(costs.ProgramReport(name="y", backend="cpu",
                                                flops=1e12), 0.01)["mfu"] \
        is None
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e13")
    assert costs.mfu(1e12, 0.5) == 0.2
    assert "x" in costs.format_table([rep])


def test_engine_cost_reports(monkeypatch):
    import _torch_pair as P
    from paddle_tpu_torch.serving import DecodeEngine
    _jm, tm = P.pair()
    eng = DecodeEngine(tm, num_slots=2, max_len=64, page_size=8,
                       device="cpu")
    reps = eng.cost_reports()
    assert sorted(reps) == ["serving.decode", "serving.prefill_chunk"]
    cfg = tm.config
    h, v, L, i = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers, \
        cfg.intermediate_size
    # the decode step's linears and head over its two slots' one token
    dense = L * 2 * 2 * h * (3 * h + h + 2 * i) + 2 * 2 * h * v
    assert reps["serving.decode"].flops >= dense
    assert reps["serving.decode"].declared_flops > 0     # its LayerNorms
    assert sorted(eng.cost_reports(only=["serving.decode"])) == \
        ["serving.decode"]
    with pytest.raises(ValueError, match="serving.cow_copy"):
        eng.cost_reports(only=["serving.cow_copy"])
    assert eng.cache.lengths.abs().sum() == 0     # nothing was committed
