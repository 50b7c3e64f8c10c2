"""paddle_tpu_torch's checkpoint manager (``incubate.checkpoint``) through
the checkpoint scenarios of ``tests/test_chaos.py`` (integrity,
fallback, no silent partials, the flush at exit, the emergency
checkpoint on preemption), run against the port; then the tiny GPT under
``TrainStep`` (AdamW, dropout 0.1, per layer and ``stack_layers``) saved
through ``TrainEpochRange`` and resumed into a fresh step bit for bit as
the run that never stopped, the same resume held against
``paddle_tpu``'s uninterrupted ``TrainStep`` from the same numpy weights
at dropout 0 (1e-5: f32 on both sides, sums in other orders), and a
two-rank gloo save (both ``host-<rank>`` files, rank 0 publishing only
when both are there)."""
import errno
import hashlib
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.checkpoint import (
    CheckpointCorruptionError, CheckpointFallbackWarning, CheckpointManager,
    CheckpointWriteError, NoUsableCheckpointError, TrainEpochRange, sliced)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.robustness import faultpoints as fp
from paddle_tpu_torch.robustness.preemption import (PREEMPTED_RC,
                                                    PreemptionGuard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX package's TrainStep against the port's resumed one: f32 on both
# sides, the sums in other orders (XLA against ATen)
JAX_ATOL = 1e-5


def test_sites_declared():
    assert {"checkpoint.shard_write", "checkpoint.shard_file",
            "checkpoint.publish", "checkpoint.restore_read",
            "train.epoch"} <= set(fp.SITES)


# -- integrity, fallback, no silent partials ---------------------------------

def test_manifest_written_and_matches(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"v": np.arange(4.0), "t": torch.arange(3.0)})
    d = os.path.join(str(tmp_path), "ckpt-1")
    with open(os.path.join(d, "host-0.manifest.json")) as f:
        man = json.load(f)
    blob = open(os.path.join(d, "host-0.ckpt"), "rb").read()
    assert man["nbytes"] == len(blob)
    assert man["sha256"] == hashlib.sha256(blob).hexdigest()
    out = mgr.restore()
    np.testing.assert_array_equal(out["v"], np.arange(4.0))
    assert torch.equal(out["t"], torch.arange(3.0))


def test_enospc_sync_save_publishes_nothing(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"v": 1})
    plan = fp.FaultPlan().inject("checkpoint.shard_write", fp.DiskFull())
    with fp.chaos(plan):
        with pytest.raises(OSError) as ei:
            mgr.save(2, {"v": 2})
    assert ei.value.errno == errno.ENOSPC
    plan.assert_all_fired()
    assert mgr.all_steps() == [1]
    assert mgr.restore()["v"] == 1
    mgr.save(3, {"v": 3})
    assert mgr.latest_step() == 3


def test_enospc_async_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    plan = fp.FaultPlan().inject("checkpoint.shard_write", fp.DiskFull())
    with fp.chaos(plan):
        mgr.save(5, {"v": 5})
        with pytest.raises(RuntimeError, match="async checkpoint failed"):
            mgr.wait()
    plan.assert_all_fired()
    assert mgr.all_steps() == []


def test_torn_shard_write_is_never_published(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    plan = fp.FaultPlan().inject("checkpoint.shard_file",
                                 fp.TornFile(frac=0.25))
    with fp.chaos(plan):
        with pytest.raises(CheckpointWriteError, match="torn shard"):
            mgr.save(1, {"v": np.arange(64.0)})
    plan.assert_all_fired()
    assert mgr.all_steps() == []
    assert not os.path.exists(os.path.join(str(tmp_path), "ckpt-1", "DONE"))


def test_corrupt_newest_restore_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"v": torch.full((4,), 1.0)})
    mgr.save(2, {"v": torch.full((4,), 2.0)})
    shard = os.path.join(str(tmp_path), "ckpt-2", "host-0.ckpt")
    blob = bytearray(open(shard, "rb").read())
    blob[len(blob) // 2] ^= 0x40
    open(shard, "wb").write(bytes(blob))
    with pytest.warns(CheckpointFallbackWarning, match="ckpt-2.*unusable"):
        out = mgr.restore()
    assert torch.equal(out["v"], torch.full((4,), 1.0))
    with pytest.raises(CheckpointCorruptionError, match="sha256"):
        mgr.restore(step=2)


def test_truncated_newest_restore_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"v": 1.0})
    mgr.save(2, {"v": 2.0})
    shard = os.path.join(str(tmp_path), "ckpt-2", "host-0.ckpt")
    os.truncate(shard, os.path.getsize(shard) // 2)
    with pytest.warns(CheckpointFallbackWarning):
        assert mgr.restore()["v"] == 1.0
    with pytest.raises(CheckpointCorruptionError, match="torn"):
        mgr.restore(step=2)


def test_unpicklable_newest_restore_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"v": 1.0})
    mgr.save(2, {"v": 2.0})
    d = os.path.join(str(tmp_path), "ckpt-2")
    garbage = b"not a pickle at all"
    open(os.path.join(d, "host-0.ckpt"), "wb").write(garbage)
    with open(os.path.join(d, "host-0.manifest.json"), "w") as f:
        json.dump({"sha256": hashlib.sha256(garbage).hexdigest(),
                   "nbytes": len(garbage), "host": 0, "step": 2}, f)
    with pytest.warns(CheckpointFallbackWarning, match="unpicklable"):
        assert mgr.restore()["v"] == 1.0


def test_every_checkpoint_bad_raises_typed(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"v": 1.0})
    mgr.save(2, {"v": 2.0})
    for s in (1, 2):
        os.truncate(os.path.join(str(tmp_path), f"ckpt-{s}", "host-0.ckpt"),
                    3)
    with pytest.warns(CheckpointFallbackWarning):
        with pytest.raises(NoUsableCheckpointError, match="every candidate"):
            mgr.restore()
    mgr2 = CheckpointManager(str(tmp_path / "empty"), async_save=False)
    with pytest.raises(FileNotFoundError):
        mgr2.restore()


def test_restore_read_faultpoint_bitflip_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"v": np.arange(32.0)})
    mgr.save(2, {"v": np.arange(32.0) * 2})
    plan = fp.FaultPlan(seed=9).inject("checkpoint.restore_read",
                                       fp.BitFlip(), at=0)
    with fp.chaos(plan):
        with pytest.warns(CheckpointFallbackWarning):
            out = mgr.restore()
    plan.assert_all_fired()
    np.testing.assert_array_equal(out["v"], np.arange(32.0))


def test_close_flushes_and_rejects_further_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"v": 1.0})
    mgr.close()
    assert mgr.all_steps() == [1]
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save(2, {"v": 2.0})
    mgr.close()


def test_retention_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=True)
    for s in range(5):
        mgr.save(s, {"v": s})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_dtypes_templates_and_a_torn_sliced_leaf(tmp_path):
    """bf16 round-trips bit for bit; a template's tensor gives the
    restored one its dtype; a sliced leaf whose slices do not cover the
    array raises instead of leaving zeros."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    b = torch.randn(5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    mgr.save(1, {"b": b, "i": torch.arange(3, dtype=torch.int32)})
    out = mgr.restore(template={"b": b, "i": torch.zeros(3,
                                                         dtype=torch.int64)})
    assert out["b"].dtype == torch.bfloat16 and torch.equal(out["b"], b)
    assert out["i"].dtype == torch.int64
    mgr.save(2, {"w": sliced(torch.ones(2, 3), (4, 3), ((0, 2), (0, 3)))})
    with pytest.raises(ValueError, match="missing or torn"):
        mgr.restore(step=2)


def test_async_save_is_a_snapshot(tmp_path):
    """A CPU tensor changed in place after ``save`` returns does not reach
    the queued checkpoint."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    t = torch.zeros(1 << 16)
    mgr.save(1, {"t": t})
    t.add_(1.0)
    mgr.wait()
    assert float(mgr.restore()["t"].abs().max()) == 0.0


def test_atexit_flushes_queued_async_saves(tmp_path):
    """A process that exits right after an async ``save()`` still lands
    the checkpoint: the exit hook drains the writer's queue."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        from paddle_tpu_torch.incubate.checkpoint import CheckpointManager
        mgr = CheckpointManager(sys.argv[1], async_save=True)
        mgr.save(4, {"v": np.arange(1024.0)})
    """)
    r = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.all_steps() == [4], os.listdir(str(tmp_path))
    np.testing.assert_array_equal(mgr.restore()["v"], np.arange(1024.0))


# -- TrainEpochRange: preemption and resume -----------------------------------

def test_epoch_range_drains_emergency_checkpoint_on_simulated_preempt(
        tmp_path):
    state = {"w": 0.0}

    def mk_range():
        r = TrainEpochRange(6, checkpoint_dir=str(tmp_path),
                            save_interval=100,
                            preemption_guard=PreemptionGuard(install=False))
        r.register("s", lambda: dict(state), state.update)
        return r

    plan = fp.FaultPlan().inject("train.epoch", fp.Preempt(), at=2)
    done = []
    with fp.chaos(plan):
        with pytest.raises(SystemExit) as ei:
            for epoch in mk_range().get():
                state["w"] += 1.0
                done.append(epoch)
    assert ei.value.code == PREEMPTED_RC
    plan.assert_all_fired()
    assert done == [0, 1, 2]
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.latest_step() == 2
    state2 = {"w": -99.0}
    r2 = TrainEpochRange(6, checkpoint_dir=str(tmp_path), save_interval=100)
    r2.register("s", lambda: dict(state2), state2.update)
    assert list(r2.get()) == [3, 4, 5]
    assert state2["w"] == 3.0


def test_epoch_range_resume_falls_back_past_corrupt_newest(tmp_path):
    state = {"w": 0.0}
    r = TrainEpochRange(4, checkpoint_dir=str(tmp_path), save_interval=1)
    r.register("s", lambda: dict(state), state.update)
    for _epoch in r.get():
        state["w"] += 1.0
    newest = max(r.manager.all_steps())
    shard = os.path.join(str(tmp_path), f"ckpt-{newest}", "host-0.ckpt")
    os.truncate(shard, os.path.getsize(shard) // 2)
    state2 = {"w": -1.0}
    r2 = TrainEpochRange(6, checkpoint_dir=str(tmp_path), save_interval=100)
    r2.register("s", lambda: dict(state2), state2.update)
    with pytest.warns(CheckpointFallbackWarning):
        resumed = list(r2.get())
    assert resumed == list(range(newest, 6))
    assert state2["w"] == float(newest)


_SIGTERM_SCRIPT = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    import torch
    from paddle_tpu_torch.incubate.checkpoint import TrainEpochRange
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    ckdir, mode = sys.argv[1], sys.argv[2]
    torch.manual_seed(7)
    net = torch.nn.Sequential(torch.nn.Linear(4, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 1))
    step = TrainStep(net, torch.nn.functional.mse_loss,
                     AdamW(learning_rate=1e-2, parameters=net.parameters()),
                     device="cpu")
    rng = np.random.RandomState(0)
    data = [(torch.as_tensor(rng.randn(8, 4).astype('float32')),
             torch.as_tensor(rng.randn(8, 1).astype('float32')))
            for _ in range(4)]
    r = TrainEpochRange(8, checkpoint_dir=ckdir, save_interval=100,
                        preemption_guard=True)
    r.register_train_step(step)
    losses = []
    for epoch in r.get():
        for x, y in data:
            losses.append(float(step(x, y)))
        if mode == "wait_for_sigterm" and epoch == 1:
            # linger inside the epoch until the signal has landed: the
            # boundary check after it drains the emergency checkpoint
            open(os.path.join(ckdir, "ready_for_term"), "w").close()
            deadline = time.time() + 30
            while not r.preemption_guard.preempted \
                    and time.time() < deadline:
                time.sleep(0.01)
    print("LOSSES", ",".join(repr(l) for l in losses))
""")


def test_sigterm_emergency_checkpoint_and_bitwise_resume(tmp_path):
    """A real SIGTERM mid-epoch: the worker drains an emergency checkpoint
    and exits PREEMPTED_RC; the resumed run repeats the uninterrupted
    run's losses bit for bit."""
    def run(d, mode):
        return subprocess.run([sys.executable, "-c", _SIGTERM_SCRIPT, d,
                               mode], capture_output=True, text=True,
                              timeout=120, cwd=REPO)
    ref_dir = str(tmp_path / "ref")
    os.makedirs(ref_dir)
    ref = run(ref_dir, "ok")
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref_losses = ref.stdout.split("LOSSES ")[1].strip().split(",")
    ck = str(tmp_path / "preempted")
    os.makedirs(ck)
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_SCRIPT, ck, "wait_for_sigterm"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    ready = os.path.join(ck, "ready_for_term")
    deadline = time.time() + 120
    while not os.path.exists(ready) and time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError("worker died early: "
                                 + proc.communicate()[1][-2000:])
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == PREEMPTED_RC, (proc.returncode, err[-2000:])
    assert CheckpointManager(ck, async_save=False).latest_step() == 1
    resumed = run(ck, "ok")
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    res_losses = resumed.stdout.split("LOSSES ")[1].strip().split(",")
    assert res_losses == ref_losses[2 * 4:]


# -- the tiny GPT: a resumed TrainStep continues bit for bit ------------------

def _gpt_step(dropout, seed, stack_layers, init_seed=0):
    cfg = GPTConfig(**dict(vars(GPTConfig.tiny()),
                           hidden_dropout_prob=dropout,
                           attention_dropout_prob=dropout))
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        init_seed))
    return TrainStep(model, GPTPretrainingCriterion(),
                     AdamW(learning_rate=1e-3, weight_decay=0.01,
                           parameters=model.parameters()),
                     device="cpu", stack_layers=stack_layers, seed=seed)


def _gpt_batches(n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.integers(0, 512, (2, 16))) for _ in range(n)]


def _run_range(step, directory, epochs, batches):
    r = TrainEpochRange(epochs, checkpoint_dir=directory, save_interval=1)
    r.register_train_step(step)
    return {e: float(step(batches[e], batches[e])) for e in r.get()}


@pytest.mark.parametrize("stack_layers", [False, True],
                         ids=["per_layer", "stack_layers"])
def test_gpt_train_step_resumes_bit_for_bit(tmp_path, stack_layers):
    """Saved after step 3 and restored into a fresh step (other weights,
    another dropout seed), the steps 3..5 equal the uninterrupted run's
    bit for bit: the masters, the AdamW slots and step, and the dropout
    generator all come back."""
    batches = _gpt_batches()
    ref = _run_range(_gpt_step(0.1, 3, stack_layers), str(tmp_path / "a"),
                     6, batches)
    first = _run_range(_gpt_step(0.1, 3, stack_layers), str(tmp_path / "b"),
                       3, batches)
    assert first == {e: ref[e] for e in range(3)}
    fresh = _gpt_step(0.1, 99, stack_layers, init_seed=5)
    resumed = _run_range(fresh, str(tmp_path / "b"), 6, batches)
    assert resumed == {e: ref[e] for e in range(3, 6)}


def test_resume_without_the_generators_would_part(tmp_path):
    """The control: restoring the state but not the dropout generator
    (``register``, not ``register_train_step``) parts from the run that
    never stopped."""
    batches = _gpt_batches()
    ref = _run_range(_gpt_step(0.1, 3, False), str(tmp_path / "a"), 6,
                     batches)
    _run_range(_gpt_step(0.1, 3, False), str(tmp_path / "b"), 3, batches)
    fresh = _gpt_step(0.1, 99, False)
    r = TrainEpochRange(6, checkpoint_dir=str(tmp_path / "b"))
    r.register("train_step", fresh.state_dict, fresh.set_state_dict)
    got = {e: float(fresh(batches[e], batches[e])) for e in r.get()}
    assert got != {e: ref[e] for e in range(3, 6)}


def _jax_weights(jm, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in jm.state_dict().items():
        shape = tuple(v.shape)
        if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.05 * rng.standard_normal(shape)
        out[name] = a.astype(np.float32)
    return out


def test_resumed_step_tracks_jax_uninterrupted(tmp_path):
    """Dropout 0: the port's run saved after step 3 and resumed in a fresh
    step against ``paddle_tpu``'s uninterrupted ``TrainStep`` from the
    same numpy weights, every step within JAX_ATOL."""
    import paddle_tpu as paddle
    from paddle_tpu.jit import TrainStep as JaxTrainStep
    from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion

    from paddle_tpu_torch.convert import load_paddle_tpu_state
    jm = JaxGPT(JaxGPTConfig.tiny())
    arrays = _jax_weights(jm, 0)
    jm.set_state_dict(arrays)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01, epsilon=1e-6)
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jopt)
    batches = _gpt_batches()
    jax_losses = [float(jstep(paddle.to_tensor(b.numpy().astype(np.int32)),
                              paddle.to_tensor(b.numpy().astype(np.int32))
                              ).numpy()) for b in batches]

    def port_step():
        tm = GPTForCausalLM(GPTConfig.tiny())
        load_paddle_tpu_state(tm, arrays)
        return TrainStep(tm, GPTPretrainingCriterion(),
                         AdamW(learning_rate=1e-3, weight_decay=0.01,
                               epsilon=1e-6, parameters=tm.parameters()),
                         device="cpu")
    first = _run_range(port_step(), str(tmp_path), 3, batches)
    resumed = _run_range(port_step(), str(tmp_path), 6, batches)
    got = [first[e] for e in range(3)] + [resumed[e] for e in range(3, 6)]
    np.testing.assert_allclose(got, jax_losses, rtol=0, atol=JAX_ATOL)


# -- several ranks -------------------------------------------------------------

def test_two_rank_gloo_save_publishes_only_complete(tmp_path):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_dist
    world = _torch_dist.World(2)
    try:
        outs = world.run("_torch_launch:job_ckpt_two_ranks",
                         directory=str(tmp_path))
    finally:
        world.close()
    for out in outs:
        assert out["files"] == ["DONE", "host-0.ckpt", "host-0.manifest.json",
                                "host-1.ckpt", "host-1.manifest.json"]
        np.testing.assert_array_equal(out["w"],
                                      np.arange(24.0).reshape(4, 6))
        assert out["step"] == 1
        assert out["steps"] == [1]
    assert "hosts [1] absent" in outs[0]["err"]
    assert outs[1]["err"] is None
