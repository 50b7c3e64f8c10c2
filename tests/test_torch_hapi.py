"""paddle_tpu_torch.hapi against paddle_tpu.hapi on the CPU: ``Model.fit``
of the tiny GPT over the same seeded batches (losses within 1e-5 batch by
batch, through every callback: ProgBarLogger, ModelCheckpoint,
EarlyStopping, LRScheduler, ReduceLROnPlateau, VisualDL,
DivergenceMonitor), ``evaluate``, ``predict``, ``save`` / ``load``, a
JAX-written ``.pdparams`` read by the port in a process that never imports
paddle_tpu, the fit telemetry, ``summary`` and ``flops``."""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import _torch_guard as G
from _torch_threads import one_thread  # noqa: F401  (autouse)
import paddle_tpu as paddle
import paddle_tpu.callbacks as jcb
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.io import TensorDataset as JaxTensorDataset
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
import paddle_tpu_torch.callbacks as tcb
from paddle_tpu_torch import framework, hapi
from paddle_tpu_torch.io import TensorDataset
from paddle_tpu_torch.observability import hbm, registry

N_TRAIN, N_EVAL = 8, 4


def _data(seed, n):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, G.VOCAB, (n, 16)).astype(np.int32)
    return ids, ids.copy(), np.ones((n, 16), np.float32)


def _models(lr=1e-3):
    jm, tm = G.models()
    jmodel = JaxModel(jm)
    jcrit = JaxCriterion()
    jmodel.prepare(G.jax_opt(jm, lr), lambda lg, lb, m: jcrit(lg, lb, m))
    tmodel = hapi.Model(tm)
    tmodel.prepare(G.port_opt(tm, lr), G.GPTPretrainingCriterion(),
                   device="cpu")
    return jmodel, tmodel


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses, self.evals = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

        def on_eval_end(self, logs=None):
            self.evals.append(logs["eval_loss"])
    return Recorder()


def _fit(model, cbmod, ds_cls, tmp, callbacks):
    rec = _recorder(cbmod.Callback)
    train, evals = ds_cls(list(_data(1, N_TRAIN))), \
        ds_cls(list(_data(2, N_EVAL)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.fit(train, evals, batch_size=2, epochs=3, shuffle=False,
                  verbose=1, log_freq=2, save_dir=str(tmp / "ckpt"),
                  callbacks=[rec] + callbacks)
    return rec


def _port_callbacks(mod, tmp):
    # no eval loss improves by 10: every eval after the first halves the lr
    return [mod.ReduceLROnPlateau(monitor="eval_loss", mode="min",
                                  min_delta=10.0, patience=0, factor=0.5,
                                  verbose=0),
            mod.VisualDL(str(tmp / "vdl")), mod.LRScheduler(),
            mod.DivergenceMonitor(snapshot_every=2)]


def test_fit_evaluate_predict_save_load_track_jax(tmp_path, capsys):
    jmodel, tmodel = _models()
    jt, tt = tmp_path / "jax", tmp_path / "port"
    jrec = _fit(jmodel, jcb, JaxTensorDataset, jt, _port_callbacks(jcb, jt))
    samples = registry.counter("train.samples").value
    trec = _fit(tmodel, tcb, TensorDataset, tt, _port_callbacks(tcb, tt))
    assert registry.counter("train.samples").value == samples + 3 * N_TRAIN
    out = capsys.readouterr().out
    assert "Epoch 0 step 0: loss:" in out and "Epoch 2 done in" in out
    # 3 epochs of 4 batches; ReduceLROnPlateau halved the lr at the second
    # and the third eval (epoch 2 ran at half of it)
    assert len(trec.losses) == len(jrec.losses) == 3 * N_TRAIN // 2
    np.testing.assert_allclose(trec.losses, jrec.losses, atol=G.ATOL,
                               rtol=0)
    np.testing.assert_allclose(trec.evals, jrec.evals, atol=G.ATOL, rtol=0)
    assert tmodel._optimizer.get_lr() == jmodel._optimizer.get_lr() == \
        pytest.approx(1e-3 * 0.25, rel=1e-12)
    # VisualDL's scalars, tag by tag
    def scalars(root):
        with open(root / "vdl" / "scalars.jsonl") as f:
            return [json.loads(line) for line in f]
    ts, js = scalars(tt), scalars(jt)
    assert [(d["tag"], d["step"]) for d in ts] == \
        [(d["tag"], d["step"]) for d in js]
    np.testing.assert_allclose([d["value"] for d in ts],
                               [d["value"] for d in js], atol=G.ATOL)
    # ModelCheckpoint wrote every epoch, in the same files
    assert sorted(os.listdir(tt / "ckpt")) == sorted(os.listdir(jt / "ckpt"))
    # evaluate and predict
    ev = _data(3, N_EVAL)
    tlog = tmodel.evaluate(TensorDataset(list(ev)), batch_size=2)
    jlog = jmodel.evaluate(JaxTensorDataset(list(ev)), batch_size=2)
    assert abs(tlog["eval_loss"] - jlog["eval_loss"]) <= G.ATOL
    tpred = tmodel.predict(TensorDataset([ev[0]]), batch_size=2)
    jpred = jmodel.predict(JaxTensorDataset([ev[0]]), batch_size=2)
    assert len(tpred) == len(jpred) == N_EVAL // 2
    for t, j in zip(tpred, jpred):
        np.testing.assert_allclose(t.numpy(), j.numpy(), atol=1e-4)
    # save and load: a fresh port model given the saved state predicts
    # the same logits
    tmodel.save(str(tmp_path / "port_final"))
    _jm, fresh = G.models(seed=9)
    m2 = hapi.Model(fresh)
    m2.prepare(G.port_opt(fresh), G.GPTPretrainingCriterion(), device="cpu")
    m2.load(str(tmp_path / "port_final"))
    again = m2.predict(TensorDataset([ev[0]]), batch_size=2)
    for a, b in zip(again, tpred):
        assert torch.equal(a, b)


def test_early_stopping_and_divergence_monitor_stop_like_jax(tmp_path):
    def run(model, mod, ds_cls):
        rec = _recorder(mod.Callback)
        es = mod.EarlyStopping(monitor="eval_loss", min_delta=10.0,
                               patience=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model.fit(ds_cls(list(_data(1, N_TRAIN))),
                      ds_cls(list(_data(2, N_EVAL))), batch_size=2,
                      epochs=4, shuffle=False, verbose=0,
                      callbacks=[rec, es])
        return rec, es
    jmodel, tmodel = _models()
    (jrec, jes), (trec, tes) = run(jmodel, jcb, JaxTensorDataset), \
        run(tmodel, tcb, TensorDataset)
    assert len(trec.losses) == len(jrec.losses) == 2 * N_TRAIN // 2
    assert tes.stop_training and jes.stop_training
    np.testing.assert_allclose(trec.losses, jrec.losses, atol=G.ATOL)


def test_jax_written_pdparams_loads_without_paddle_tpu(tmp_path):
    jm, _tm = G.models(seed=4)
    jmodel = JaxModel(jm)
    jmodel.prepare(G.jax_opt(jm), None)
    jmodel.save(str(tmp_path / "jax"))
    want = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    script = (
        "import sys, json, numpy as np\n"
        "from paddle_tpu_torch import framework\n"
        "sd = framework.load(sys.argv[1])\n"
        "assert not any(m == 'paddle_tpu' or m.startswith('paddle_tpu.')\n"
        "               for m in sys.modules), 'paddle_tpu imported'\n"
        "np.savez(sys.argv[2], **{k: v.detach().numpy()\n"
        "                        for k, v in sd.items()})\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    subprocess.run([sys.executable, "-c", script,
                    str(tmp_path / "jax.pdparams"), str(tmp_path / "x.npz")],
                   check=True, env=env, timeout=120)
    got = np.load(tmp_path / "x.npz")
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    # and into a port model through Model.load
    _jm, fresh = G.models(seed=5)
    m = hapi.Model(fresh)
    m.prepare(None, None, device="cpu")
    m.load(str(tmp_path / "jax"))
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])


def test_jax_bf16_payload_loads_by_its_bits():
    import io
    from paddle_tpu import framework as jax_framework
    vals = np.array([1.5, -2.25, 3.0, 1e-3], np.float32)
    buf = io.BytesIO()
    jax_framework.save({"w": paddle.to_tensor(vals).astype("bfloat16")},
                       buf)
    buf.seek(0)
    got = framework.load(buf)["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(vals).bfloat16())


def test_framework_payload_round_trip_bf16():
    sd = {"w": torch.nn.Parameter(torch.randn(3, 2).bfloat16()),
          "step": torch.tensor(7), "nested": [torch.ones(2)], "lr": 0.5}
    out = framework.load(framework.save_to_memory(sd))
    assert isinstance(out["w"], torch.nn.Parameter)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], sd["w"].detach())
    assert int(out["step"]) == 7 and out["lr"] == 0.5
    assert torch.equal(out["nested"][0], torch.ones(2))


def test_fit_samples_hbm_ledger_at_each_batch():
    assert hbm.active() is None and hbm.maybe_sample("x") is None
    _jmodel, tmodel = _models()
    led = hbm.enable()
    tags = []
    orig = led.sample

    def sample(tag=""):
        tags.append(tag)
        return orig(tag)
    led.sample = sample
    try:
        tmodel.fit(TensorDataset(list(_data(1, 4))), batch_size=2,
                   epochs=1, shuffle=False, verbose=0)
    finally:
        hbm.disable()
    assert tags == ["train.batch"] * 2


def test_summary_and_flops():
    _jm, tm = G.models()
    info = hapi.summary(tm)
    n = sum(p.numel() for p in tm.parameters())
    assert info == {"total_params": n, "trainable_params": n}
    cfg = tm.config
    b, s, h, v, L, i = 2, 16, cfg.hidden_size, cfg.vocab_size, \
        cfg.num_hidden_layers, cfg.intermediate_size
    heads = cfg.num_attention_heads
    t = b * s
    # the linears, the tied head, causal attention, 2L + 1 LayerNorms
    want = (L * 2 * t * h * (3 * h + h + 2 * i) + 2 * t * h * v
            + L * 4 * b * heads * (h // heads) * (s * (s + 1) // 2)
            + (2 * L + 1) * 8 * t * h)
    assert hapi.flops(tm, input_size=[b, s], dtypes="int64") == want
