"""paddle_tpu_torch's divergence sentinel and training fault sites against
paddle_tpu's on the CPU (the scenarios of ``tests/test_chaos.py``'s
sentinel and amp sections): spike windows, the scaler's grace, ring
exhaustion with its typed error and ``"divergence"`` flight dump,
``NaNBatch`` at ``train.grads`` step 5 rewound and replayed bit for bit
(the tiny GPT, losses within 1e-5 of the JAX run's), the same at dropout
0.1 (which holds only because a snapshot keeps the step's dropout
generators), ``ForceFoundInf`` at ``amp.found_inf`` and
``DivergenceMonitor``."""
import contextlib
import json
import warnings

import numpy as np
import pytest
import torch

import _torch_guard as G
from _torch_threads import one_thread  # noqa: F401  (autouse)
from paddle_tpu.callbacks import DivergenceMonitor as JaxMonitor
from paddle_tpu.robustness import faultpoints as jfp
from paddle_tpu.robustness.sentinel import \
    DivergenceSentinel as JaxSentinel
from paddle_tpu_torch import amp
from paddle_tpu_torch.callbacks import DivergenceMonitor
from paddle_tpu_torch.observability import flight, registry
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.robustness import faultpoints as fp
from paddle_tpu_torch.robustness import sentinel as sn


class _StubStep:
    """Minimal state_dict/set_state_dict holder for detector-logic tests."""

    def __init__(self):
        self.state = {"w": 0.0}

    def state_dict(self):
        return dict(self.state)

    def set_state_dict(self, sd):
        self.state = dict(sd)


def _stub_trajectory(cls, err_cls):
    """The test_chaos spike/ring scenario on ``cls``: what observe returns
    and what state each rewind restores."""
    stub = _StubStep()
    s = cls(stub, window=8, spike_factor=5.0, min_history=3,
            snapshot_every=1, max_snapshots=2)
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(4):
            stub.state["w"] = float(i)
            out.append(s.observe(i, 1.0 + 0.01 * i))
        out.append(s.snapshots_available)
        out.append((s.observe(4, 50.0), stub.state["w"]))
        out.append((s.observe(4, float("inf")), stub.state["w"]))
        with pytest.raises(err_cls, match="exhausted"):
            s.observe(4, float("nan"))
    return out


def test_spike_detection_and_ring_exhaustion_match_jax():
    from paddle_tpu.robustness.sentinel import DivergenceError
    got = _stub_trajectory(sn.DivergenceSentinel, sn.DivergenceError)
    assert got == _stub_trajectory(JaxSentinel, DivergenceError)
    assert got[-2:] == [(3, 3.0), (2, 2.0)]


def test_rewind_warns_and_counts():
    stub = _StubStep()
    s = sn.DivergenceSentinel(stub, snapshot_every=1, min_history=1)
    before = registry.counter("train.divergence_rollbacks").value
    s.observe(0, 1.0)
    with pytest.warns(sn.DivergenceWarning, match="rewound"):
        assert s.observe(1, float("nan")) == 0
    assert registry.counter("train.divergence_rollbacks").value == \
        before + 1
    assert len(s.rewinds) == 1 and s.rewinds[0][:2] == (1, 0) \
        and np.isnan(s.rewinds[0][2])


def test_scaler_skip_grace():
    """A NaN the fp16 GradScaler already skipped must not trigger a rewind
    (the parameters were never touched) until the grace runs out."""
    stub = _StubStep()
    scaler = amp.GradScaler(enable=True)
    scaler._last_skipped = True
    s = sn.DivergenceSentinel(stub, scaler=scaler, snapshot_every=1,
                              max_snapshots=2, scaler_grace=3)
    s.observe(0, 1.0)
    s.observe(1, 1.0)
    assert s.observe(2, float("nan")) is None
    assert s.observe(3, float("nan")) is None
    with pytest.warns(sn.DivergenceWarning):
        assert s.observe(4, float("nan")) == 1
    assert s.rewinds and s.rewinds[-1][0] == 4
    assert scaler.last_step_skipped is False


def _guarded_run(step, batches, plan, jax=False, snapshot_every=1):
    """Losses of a loop that rewinds on divergence and replays from the
    batch after the snapshot; the JAX package's sentinel and chaos scope
    with ``jax``."""
    cls, chaos, to_batch = ((JaxSentinel, jfp.chaos, G.jax_batch) if jax
                            else (sn.DivergenceSentinel, fp.chaos,
                                  G.port_batch))
    sentinel = cls(step, snapshot_every=snapshot_every, max_snapshots=3,
                   min_history=3)
    losses = {}
    with (chaos(plan) if plan is not None else contextlib.nullcontext()), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        i = 0
        while i < len(batches):
            loss = float(np.asarray(step(*to_batch(batches[i]))))
            resumed = sentinel.observe(i, loss)
            if resumed is not None:
                i = resumed + 1     # replay from after the snapshot
                continue
            losses[i] = loss
            i += 1
    if plan is not None:
        plan.assert_all_fired()
    return [losses[i] for i in range(len(batches))], sentinel


def test_nan_batch_at_step_5_replays_bit_for_bit_and_tracks_jax():
    data = G.batches(10)
    jstep, tstep = G.steps()
    j_chaos, j_sent = _guarded_run(
        jstep, data, jfp.FaultPlan().inject("train.grads", jfp.NaNBatch(),
                                            at=5), jax=True)
    t_chaos, t_sent = _guarded_run(
        tstep, data, fp.FaultPlan().inject("train.grads", fp.NaNBatch(),
                                           at=5))
    _jm, tm = G.models()
    t_clean, _ = _guarded_run(
        G.TrainStep(tm, G.GPTPretrainingCriterion(), G.port_opt(tm),
                    device="cpu"), data, None)
    assert len(t_sent.rewinds) == len(j_sent.rewinds) == 1
    assert t_sent.rewinds[0][:2] == j_sent.rewinds[0][:2] == (5, 4)
    assert all(np.isfinite(t_chaos))
    np.testing.assert_array_equal(np.array(t_chaos), np.array(t_clean))
    np.testing.assert_allclose(t_chaos, j_chaos, atol=G.ATOL, rtol=0)


def _dropout_run(plan, keep_generators=True, monkeypatch=None):
    _jm, tm = G.models(dropout=0.1)
    step = G.TrainStep(tm, G.GPTPretrainingCriterion(), G.port_opt(tm),
                       device="cpu", seed=3)
    if not keep_generators:
        monkeypatch.setattr(sn, "_generators", lambda train_step: [])
    return _guarded_run(step, G.batches(8), plan, snapshot_every=2)


def test_dropout_replay_needs_the_step_generators(monkeypatch):
    """At dropout 0.1 the replayed losses are the clean run's bit for bit
    only because a snapshot holds the step's dropout generators: leave
    them out and the replay draws other masks."""
    def plan():
        return fp.FaultPlan().inject("train.grads", fp.NaNBatch(), at=5)
    clean, _ = _dropout_run(None)
    chaos, sent = _dropout_run(plan())
    assert len(sent.rewinds) == 1 and sent.rewinds[0][:2] == (5, 4)
    np.testing.assert_array_equal(np.array(chaos), np.array(clean))
    broken, _ = _dropout_run(plan(), keep_generators=False,
                             monkeypatch=monkeypatch)
    assert broken[:4] == clean[:4]
    assert broken[5:] != clean[5:]


def test_snapshot_holds_the_step_state_on_the_host():
    _jstep, tstep = G.steps()
    tstep(*G.port_batch(G.batches(1)[0]))
    s = sn.DivergenceSentinel(tstep)
    s.snapshot(0)
    masters = sum(t.numel() * 4 for t in tstep.params.values())
    # masters, Adam's two moments, and the step / LR scalars
    assert 3 * masters <= s.last_snapshot_bytes < 3 * masters + 4096
    assert s.last_snapshot_seconds >= 0.0
    assert len(s._ring[-1]["generators"]) == 1


def test_forced_found_inf_skips_update_and_counts():
    torch.manual_seed(0)
    net = torch.nn.Linear(4, 2)
    opt = SGD(learning_rate=0.1, parameters=list(net.parameters()))
    scaler = amp.GradScaler(enable=True, init_loss_scaling=8.0,
                            decr_every_n_nan_or_inf=1)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (4, 4)).astype(np.float32))
    w_before = net.weight.detach().clone()
    scaler.scale(net(x).sum()).backward()
    skipped = registry.counter("train.amp_skipped_steps").value
    plan = fp.FaultPlan().inject("amp.found_inf", fp.ForceFoundInf())
    with fp.chaos(plan):
        scaler.step(opt)
    plan.assert_all_fired()
    assert scaler.last_step_skipped
    assert torch.equal(net.weight.detach(), w_before)
    assert scaler.get_loss_scaling() == 4.0      # the JAX scaler's too
    assert registry.counter("train.amp_skipped_steps").value == skipped + 1
    # without the fault the same scaler updates
    scaler.step(opt)
    assert not scaler.last_step_skipped
    assert not torch.equal(net.weight.detach(), w_before)


def test_int_only_batch_passes_nan_batch_unchanged():
    ids = np.arange(6, dtype=np.int32).reshape(2, 3)
    ctx = {"batch": (ids, torch.as_tensor(ids))}
    fp.NaNBatch().fire(ctx, None)
    assert ctx["batch"][0] is ids and torch.equal(ctx["batch"][1],
                                                  torch.as_tensor(ids))


def _monitor_drive(cls):
    cb = cls(max_rewinds=2, snapshot_every=1, min_history=3)

    class FakeModel:
        _train_step = _StubStep()
        stop_training = False

    cb.set_model(FakeModel)
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(4):
            FakeModel._train_step.state["w"] = float(i)
            cb.on_train_batch_end(i, {"loss": 1.0})
        cb.on_train_batch_end(4, {"loss": float("nan")})
        out.append((cb.rewinds, FakeModel._train_step.state["w"]))
        cb.on_train_batch_end(5, {"loss": float("nan")})
        out.append((cb.rewinds, FakeModel.stop_training))
    return out


def test_divergence_monitor_matches_jax():
    got = _monitor_drive(DivergenceMonitor)
    assert got == _monitor_drive(JaxMonitor)
    assert got == [(1, 3.0), (2, True)]


def test_flight_dump_on_divergence_ring_exhausted(tmp_path):
    flight.enable(dir=str(tmp_path))
    try:
        s = sn.DivergenceSentinel(_StubStep(), min_history=1)
        with pytest.raises(sn.DivergenceError):
            s.observe(0, float("nan"))   # no snapshot yet: ring dry
        with open(flight.last_dump_path()) as f:
            doc = json.load(f)
    finally:
        flight.disable()
    assert doc["trigger"]["kind"] == "divergence"
    assert doc["ring"][-1]["kind"] == "trigger"
    assert isinstance(doc["compile_counts"], dict)
    assert doc["hbm"]["armed"] is False and "top_arrays" in doc["hbm"]
