"""paddle_tpu_torch optimizers against paddle_tpu's on the same arrays:
``apply_gradients`` of SGD, Momentum, Adam and AdamW over several steps
(coupled L2 and L1 decay, decoupled decay with ``apply_decay_param_fun``,
amsgrad, bf16 moments, each grad-clip class), the eager ``step()`` on
bf16 parameters with its f32 master slot against the f32-master route,
the LR schedulers' value sequences, and the fp16 GradScaler."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch import nn, optimizer, regularizer
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.optimizer import lr as torch_lr

SHAPES = {"a.bias": (3,), "a.weight": (4, 3), "b.weight": (5,)}


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _case(name):
    """(JAX optimizer, port optimizer) of one configuration."""
    def both(cls, **kw):
        jkw = {k: _jax_twin(v) for k, v in kw.items()}
        return (getattr(paddle.optimizer, cls)(parameters=[], **jkw),
                getattr(optimizer, cls)(parameters=[], **kw))
    no_bias = lambda n: not n.endswith("bias")   # noqa: E731
    return {
        "sgd_l2": lambda: both("SGD", learning_rate=0.1, weight_decay=0.01),
        "momentum_nesterov": lambda: both(
            "Momentum", learning_rate=0.1, momentum=0.9, use_nesterov=True,
            weight_decay=regularizer.L2Decay(0.01)),
        "adam_l1_amsgrad": lambda: both(
            "Adam", learning_rate=1e-2, amsgrad=True,
            weight_decay=regularizer.L1Decay(0.01)),
        "adamw_decay_fun": lambda: both(
            "AdamW", learning_rate=1e-2, weight_decay=0.05,
            apply_decay_param_fun=no_bias),
        "adamw_l1": lambda: both("AdamW", learning_rate=1e-2,
                                 weight_decay=regularizer.L1Decay(0.01)),
        "adam_bf16_moments": lambda: both("Adam", learning_rate=1e-2,
                                          moment_dtype="bfloat16"),
        "adamw_global_clip": lambda: both(
            "AdamW", learning_rate=1e-2,
            grad_clip=nn.ClipGradByGlobalNorm(0.5)),
        "sgd_norm_clip": lambda: both("SGD", learning_rate=0.1,
                                      grad_clip=nn.ClipGradByNorm(0.3)),
        "momentum_value_clip": lambda: both(
            "Momentum", learning_rate=0.1,
            grad_clip=nn.ClipGradByValue(0.2)),
    }[name]()


def _jax_twin(v):
    """The JAX package's object for a port regularizer / clip."""
    for cls in (regularizer.L1Decay, regularizer.L2Decay):
        if isinstance(v, cls):
            return getattr(paddle.regularizer, cls.__name__)(v.coeff)
    if isinstance(v, nn.ClipGradByGlobalNorm):
        return paddle.nn.ClipGradByGlobalNorm(v.clip_norm)
    if isinstance(v, nn.ClipGradByNorm):
        return paddle.nn.ClipGradByNorm(v.clip_norm)
    if isinstance(v, nn.ClipGradByValue):
        return paddle.nn.ClipGradByValue(v.max, v.min)
    return v


@pytest.mark.parametrize("case", [
    "sgd_l2", "momentum_nesterov", "adam_l1_amsgrad", "adamw_decay_fun",
    "adamw_l1", "adam_bf16_moments", "adamw_global_clip", "sgd_norm_clip",
    "momentum_value_clip"])
def test_apply_gradients_matches_jax(case):
    jopt, topt = _case(case)
    params = _arrays(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jopt.init_state(jp), topt.init_state(tp)
    for step in range(4):
        grads = _arrays(10 + step, scale=0.5)
        jp, jstate = jopt.apply_gradients(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, jstate,
            jnp.asarray(jopt.get_lr(), jnp.float32))
        tp, tstate = topt.apply_gradients(
            tp, {k: torch.from_numpy(v) for k, v in grads.items()}, tstate,
            topt.get_lr())
        assert tstate["step"] == int(jstate["step"]) == step + 1
        for k in SHAPES:
            # f32 on both sides, the same operations in the same order
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6,
                                       err_msg="%s step %d" % (k, step))
            for slot, v in tstate["slots"][k].items():
                w = np.asarray(jnp.asarray(jstate["slots"][k][slot],
                                           jnp.float32))
                assert str(v.dtype).split(".")[-1] == \
                    str(jstate["slots"][k][slot].dtype)
                np.testing.assert_allclose(v.float().numpy(), w, atol=1e-6,
                                           rtol=1e-5, err_msg=slot)


def test_decay_fun_and_l1_change_the_update():
    """The cases above would pass with the features ignored on both sides
    only if they did nothing: they do something."""
    grads = {k: torch.from_numpy(v) for k, v in _arrays(1).items()}
    params = {k: torch.from_numpy(v) for k, v in _arrays(0).items()}

    def run(**kw):
        o = optimizer.AdamW(parameters=[], learning_rate=1e-2, **kw)
        return o.apply_gradients(params, grads, o.init_state(params),
                                 o.get_lr())[0]
    plain = run(weight_decay=0.05)
    fun = run(weight_decay=0.05,
              apply_decay_param_fun=lambda n: not n.endswith("bias"))
    assert torch.equal(fun["a.weight"], plain["a.weight"])
    assert not torch.equal(fun["a.bias"], plain["a.bias"])
    l1 = run(weight_decay=regularizer.L1Decay(0.05))
    assert not torch.equal(l1["a.weight"], plain["a.weight"])


def test_eager_step_with_master_slot_matches_the_f32_master_route():
    """bf16 parameters updated by opt.step() through their f32 master slot
    land exactly where apply_gradients puts f32 masters given the same
    (upcast) gradients."""
    init = _arrays(2)
    eager = [torch.nn.Parameter(torch.from_numpy(v).to(torch.bfloat16))
             for v in init.values()]
    opt = optimizer.AdamW(learning_rate=1e-2, parameters=eager,
                          weight_decay=0.01)
    ref = optimizer.AdamW(learning_rate=1e-2, parameters=[],
                          weight_decay=0.01)
    masters = {k: p.detach().float() for k, p in zip(init, eager)}
    state = ref.init_state(masters)
    for step in range(3):
        grads = _arrays(20 + step)
        for p, g in zip(eager, grads.values()):
            p.grad = torch.from_numpy(g).to(torch.bfloat16)
        opt.step()
        masters, state = ref.apply_gradients(
            masters, {k: p.grad.float() for k, p in zip(init, eager)},
            state, ref.get_lr())
        opt.clear_grad()
    sd = opt.state_dict()
    assert sd["_step_count"] == 3
    for i, (k, p) in enumerate(zip(init, eager)):
        assert p.dtype == torch.bfloat16 and p.grad is None
        slots = opt._accumulators[id(p)]
        assert {s: v.dtype for s, v in slots.items()} == {
            "moment1": torch.float32, "moment2": torch.float32,
            "master": torch.float32}
        torch.testing.assert_close(slots["master"], masters[k], atol=0,
                                   rtol=0)
        torch.testing.assert_close(p.detach(), masters[k].to(torch.bfloat16),
                                   atol=0, rtol=0)
        torch.testing.assert_close(sd["%d@moment1" % i],
                                   state["slots"][k]["moment1"], atol=0,
                                   rtol=0)
    # the state dict restores into a fresh optimizer
    again = optimizer.AdamW(learning_rate=1e-2, parameters=eager)
    again.set_state_dict(sd)
    assert again._step_count == 3
    torch.testing.assert_close(again._accumulators[id(eager[0])]["master"],
                               masters["a.bias"], atol=0, rtol=0)


def _schedulers(mod):
    return [
        mod.NoamDecay(d_model=64, warmup_steps=4, learning_rate=2.0),
        mod.PiecewiseDecay([3, 6], [1.0, 0.5, 0.1]),
        mod.NaturalExpDecay(0.5, gamma=0.1),
        mod.InverseTimeDecay(0.5, gamma=0.2),
        mod.PolynomialDecay(0.5, decay_steps=5, cycle=False),
        mod.PolynomialDecay(0.5, decay_steps=4, power=2.0, cycle=True),
        mod.LinearWarmup(mod.StepDecay(0.5, step_size=3), warmup_steps=4,
                         start_lr=0.0, end_lr=0.5),
        mod.ExponentialDecay(0.5, gamma=0.9),
        mod.MultiStepDecay(0.5, milestones=[2, 5], gamma=0.5),
        mod.StepDecay(0.5, step_size=2, gamma=0.7),
        mod.LambdaDecay(0.5, lambda e: 0.95 ** e),
        mod.MultiplicativeDecay(0.5, lambda e: 0.9),
        mod.CosineAnnealingDecay(0.5, T_max=6, eta_min=0.01),
        mod.CosineAnnealingWarmRestarts(0.5, T_0=3, T_mult=2),
        mod.OneCycleLR(0.5, total_steps=10),
        mod.OneCycleLR(0.5, total_steps=10, anneal_strategy="linear"),
        mod.CyclicLR(0.1, 0.5, step_size_up=2, mode="triangular2"),
        mod.CyclicLR(0.1, 0.5, step_size_up=3, mode="exp_range",
                     exp_gamma=0.9),
    ]


def test_lr_schedulers_match_jax_sequences():
    for j, t in zip(_schedulers(jax_lr), _schedulers(torch_lr)):
        seq_j, seq_t = [], []
        for _ in range(12):
            seq_j.append(j())
            seq_t.append(t())
            j.step()
            t.step()
        assert seq_t == seq_j, type(t).__name__
        assert t.state_dict() == j.state_dict(), type(t).__name__
    j = jax_lr.ReduceOnPlateau(0.5, patience=1, cooldown=1)
    t = torch_lr.ReduceOnPlateau(0.5, patience=1, cooldown=1)
    for metric in (3.0, 2.0, 2.5, 2.6, 2.7, 1.0, 1.5, 1.6, 1.7):
        j.step(metric)
        t.step(metric)
        assert t() == j()
    # the step uses a scheduler through the optimizer
    opt = optimizer.SGD(learning_rate=torch_lr.StepDecay(0.5, 1, 0.5),
                        parameters=[])
    assert opt.get_lr() == 0.5
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)


def test_grad_scaler_skips_and_rescales_as_jax():
    """fp16 dynamic loss scaling: a non-finite gradient skips the update
    and halves the scale, finite steps update with unscaled gradients and
    double the scale every incr_every_n_steps; an explicit unscale_
    before step() divides once.  The same gradient sequence through the
    JAX scaler gives the same scales, skips and parameters."""
    jnet = paddle.nn.Linear(3, 2)
    w0 = {p.name: np.asarray(p.numpy()) for p in jnet.parameters()}
    tparams = [torch.nn.Parameter(torch.from_numpy(w0[p.name].copy()))
               for p in jnet.parameters()]
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jnet.parameters())
    topt = optimizer.SGD(learning_rate=0.1, parameters=tparams)
    kw = dict(init_loss_scaling=8.0, decr_every_n_nan_or_inf=1,
              incr_every_n_steps=2)
    js, ts = JaxGradScaler(**kw), GradScaler(**kw)
    rng = np.random.default_rng(3)
    for i, bad in enumerate([True, False, False, False, True, False]):
        grads = [(8.0 * rng.standard_normal(p.shape)).astype(np.float32)
                 for p in tparams]
        if bad:
            grads[1][0] = np.inf
        for jp, tp, g in zip(jnet.parameters(), tparams, grads):
            jp.grad = paddle.to_tensor(g)
            tp.grad = torch.from_numpy(g.copy())
        if i == 2:
            js.unscale_(jopt)
            ts.unscale_(topt)
            ts.unscale_(topt)   # idempotent until step()
        js.step(jopt)
        ts.step(topt)
        assert ts.last_step_skipped == js.last_step_skipped == bad
        assert ts.get_loss_scaling() == js.get_loss_scaling()
        for jp, tp in zip(jnet.parameters(), tparams):
            np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(),
                                       atol=1e-6, rtol=0)
        jopt.clear_grad()
        topt.clear_grad()
    assert ts.state_dict() == js.state_dict()
    off = GradScaler(enable=False)
    x = torch.ones(2)
    assert off.scale(x) is x and not off.last_step_skipped
