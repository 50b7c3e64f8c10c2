"""``chip_smoke.py``'s fit_guard and serve_watch checks on the card, each
on a deliberately broken input too, which it must refuse: a sentinel
whose snapshots leave out the step's dropout generators (the replay is
then not bit for bit), an ``mfu`` over 1.05 and flops off the closed
form, a ledger sample off the allocator's count, a trace without its
HBM lanes or a kernel, compile counts that do not match the captures,
and a forced second capture under ``PADDLE_TPU_STRICT_COMPILE=1``.  At a
narrow width (hidden 128, two heads of 64, S = 128: every kernel gate
holds).  Marked ``gpu``: without an NVIDIA card every test skips.  This
file imports no JAX:

    python -m pytest tests/test_torch_cuda_guard.py -m gpu -q
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from paddle_tpu_torch import amp, profiler
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.observability import costs, hbm
from paddle_tpu_torch.observability import watchdog as wd
from paddle_tpu_torch.robustness import faultpoints as fp
from paddle_tpu_torch.robustness import sentinel as sn
from paddle_tpu_torch.utils import flags

pytestmark = pytest.mark.gpu

SHAPE = (2, 128)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _base():
    cfg = GPTConfig(vocab_size=512, max_position_embeddings=128,
                    hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    return GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))


@pytest.fixture
def kernels():
    _card()
    flags.set_flags({"use_pallas_norm": True, "use_pallas_ce": True})
    yield
    flags.set_flags({"use_pallas_norm": False, "use_pallas_ce": False})


def _replay(base, monkeypatch=None):
    batches = cs.guard_batches(torch, base.config.vocab_size, 8, SHAPE)
    clean, _ = cs.guarded_losses(torch, cs.make_step(cs.guard_model(
        torch, base, amp)), batches)
    if monkeypatch is not None:
        monkeypatch.setattr(sn, "_generators", lambda train_step: [])
    plan = fp.FaultPlan().inject("train.grads", fp.NaNBatch(), at=5)
    replayed, sent = cs.guarded_losses(
        torch, cs.make_step(cs.guard_model(torch, base, amp)), batches, plan,
        snapshot_every=2, max_snapshots=2, min_history=3)
    return clean, replayed, sent.rewinds


def test_replay_holds_and_fails_without_the_generators(kernels,
                                                       monkeypatch):
    base = _base()
    cs.replay_hold(*_replay(base))
    with pytest.raises(AssertionError, match="part from the clean run"):
        cs.replay_hold(*_replay(base, monkeypatch))


def _step_and_batch(base):
    step = cs.make_step(cs.guard_model(torch, base, amp))
    ids = cs.guard_batches(torch, base.config.vocab_size, 1, SHAPE)[0]
    return step, ids


def test_cost_hold_refuses_a_wrong_count_or_an_mfu_over_the_cap(kernels):
    base = _base()
    step, batch = _step_and_batch(base)
    step(*batch)
    events, device_s = cs.profiled_window(torch, profiler, hbm, step, batch)
    assert device_s > 0
    report = step.cost_report(batch)
    closed = cs.step_flops(base.config, *SHAPE)
    assert report.flops == closed and report.peak_bytes > 0
    cs.cost_hold(costs.cost_block(report, device_s), closed)
    with pytest.raises(AssertionError, match="mfu"):
        cs.cost_hold(costs.cost_block(report, device_s * 1e-6), closed)
    with pytest.raises(AssertionError, match="closed form"):
        cs.cost_hold(costs.cost_block(report, device_s), closed * 1.02)


def test_ledger_hold_refuses_a_sample_off_the_allocator():
    _card()
    x = torch.ones(1 << 20, device="cuda")
    led = hbm.enable()
    try:
        live = led.sample("probe")["devices"]["cuda:0"]
        got = float(torch.cuda.memory_allocated(0))
    finally:
        hbm.disable()
    cs.ledger_hold([(live, got)])
    with pytest.raises(AssertionError, match="memory_allocated"):
        cs.ledger_hold([(live, got + 1)])
    with pytest.raises(AssertionError, match="sampled no batch"):
        cs.ledger_hold([])
    del x


def test_trace_hold_refuses_a_trace_without_lanes_or_kernels(kernels):
    base = _base()
    step, batch = _step_and_batch(base)
    hbm.enable()
    try:
        events, _s = cs.profiled_window(torch, profiler, hbm, step, batch)
    finally:
        hbm.disable()
    cs.trace_hold(events, ["fit_guard.step"])
    with pytest.raises(AssertionError, match="HBM lanes"):
        cs.trace_hold([e for e in events if e.get("cat") != "hbm"],
                      ["fit_guard.step"])
    with pytest.raises(AssertionError, match="ce_bwd_kernel"):
        cs.trace_hold([e for e in events
                       if "ce_bwd_kernel" not in e.get("name", "")],
                      ["fit_guard.step"])


def test_watch_hold_and_a_forced_capture(monkeypatch):
    _card()
    from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                          DecodeEngine, Request)
    model = cs.train_model(torch, _base(), amp).eval()
    monkeypatch.setenv("PADDLE_TPU_STRICT_COMPILE", "1")
    before = wd.compile_counts()
    eng = DecodeEngine(model, num_slots=8, max_len=128, page_size=16)
    eng.capture_steps()
    sched = ContinuousBatchingScheduler(eng)
    rng = np.random.default_rng(0)
    for _ in range(3):
        sched.submit(Request(prompt=rng.integers(0, 512, (40,)),
                             max_new_tokens=6, temperature=0.0))
    sched.run()
    by_kind = eng.graph_stats()["by_kind"]
    after = wd.compile_counts()
    cs.watch_hold(before, after, by_kind)
    with pytest.raises(AssertionError, match="compile counts grew"):
        cs.watch_hold(before, after, dict(by_kind, decode={"captures": 2}))
    eng._graphs.clear()
    with pytest.raises(wd.RecompileError, match="serving.decode"):
        eng.capture_steps()
