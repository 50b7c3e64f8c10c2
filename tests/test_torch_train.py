"""paddle_tpu_torch training against paddle_tpu on the CPU: cross entropy
and the GPT pretraining criterion, and the gate of the training slice —
``jit.TrainStep`` with AdamW and a global-norm clip tracks
``paddle_tpu.jit.TrainStep`` step by step at the tiny GPT in f32, with
each LayerNorm route (the flagged one on a config wide enough for the
kernel's gate, JAX running its Pallas LayerNorm in interpret mode), and
with ``flat_master=True`` on both sides.  Also the training-state bridge,
the flat master's per-name state dicts, and an AMP O2 bf16 run.  Weights
and batches are numpy arrays from a seed, loaded into both."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jax_jit
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nn.functional import cross_entropy as jax_cross_entropy
from paddle_tpu.utils import flags as jax_flags
import paddle_tpu_torch.jit as torch_jit
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.convert import (load_paddle_tpu_state,
                                      train_state_from_numpy)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.kernels import ce_cuda, norm_cuda
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils import flags

# f32 on both sides; the sums run in other orders (XLA vs ATen), so the
# two trajectories part in the last bits only
ATOL = 1e-5


def _wide_kwargs():
    """A tiny config whose hidden width (128) passes the LayerNorm kernel
    gate (F % 128 == 0): two heads of 64."""
    return dict(vocab_size=512, max_position_embeddings=128, hidden_size=128,
                num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=256, hidden_dropout_prob=0.0,
                attention_dropout_prob=0.0)


def _weights(jm, seed):
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


def _pair(seed=0, wide=False, o2=False, lr=1e-3, epsilon=1e-6,
          flat_master=None):
    jcfg = JaxGPTConfig(**_wide_kwargs()) if wide else JaxGPTConfig.tiny()
    tcfg = GPTConfig(**_wide_kwargs()) if wide else GPTConfig.tiny()
    jm = JaxGPT(jcfg)
    arrays = _weights(jm, seed)
    jm.set_state_dict(arrays)
    tm = GPTForCausalLM(tcfg)
    load_paddle_tpu_state(tm, arrays)
    if o2:
        jm = paddle.amp.decorate(jm, level="O2", dtype="bfloat16")
        tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    # epsilon 1e-6 by default on both sides: the key bias's true gradient
    # is exactly zero (softmax is shift-invariant per row), so both
    # frameworks hand Adam f32 rounding noise there, and at epsilon 1e-8
    # Adam turns that noise into steps of +-lr that differ between them
    # (test_trainstep_tracks_jax_at_the_default_epsilon)
    jopt = paddle.optimizer.AdamW(
        learning_rate=lr, parameters=jm.parameters(), weight_decay=0.01,
        epsilon=epsilon, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    topt = AdamW(learning_rate=lr, parameters=tm.parameters(),
                 weight_decay=0.01, epsilon=epsilon,
                 grad_clip=ClipGradByGlobalNorm(1.0))
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jopt,
                         flat_master=flat_master)
    tstep = TrainStep(tm, GPTPretrainingCriterion(), topt, device="cpu",
                      flat_master=flat_master)
    return jstep, tstep


def _batches(n, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (b, s)).astype(np.int32) for _ in range(n)]


def _run(jstep, tstep, batches):
    jl, tl = [], []
    for ids in batches:
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(ids)).numpy()))
        loss = tstep(torch.as_tensor(ids), torch.as_tensor(ids))
        assert loss.dim() == 0
        tl.append(float(loss))
    return np.array(jl), np.array(tl)


def _jax_params(jstep):
    return {k: np.asarray(jax.device_get(v), np.float32)
            for k, v in jstep.state_dict()["params"].items()}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.default_rng(2)
    logits = (2 * rng.standard_normal((3, 5, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int64)
    labels[0, 1] = labels[2, 4] = -100
    weight = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    for kw in ({}, {"weight": weight}, {"label_smoothing": 0.1}):
        want = jax_cross_entropy(
            paddle.to_tensor(logits), paddle.to_tensor(labels),
            reduction=reduction,
            **{k: paddle.to_tensor(v) if k == "weight" else v
               for k, v in kw.items()}).numpy()
        got = cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            reduction=reduction,
            **{k: torch.from_numpy(v) if k == "weight" else v
               for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-6,
                                   err_msg=str(kw))


def test_cross_entropy_soft_labels_and_probabilities_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 20)).astype(np.float32)
    soft = rng.uniform(size=(6, 20)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    hard = rng.integers(0, 20, (6,)).astype(np.int64)
    for inp, lab, kw in ((logits, soft, {"soft_label": True}),
                         (probs, hard, {"use_softmax": False}),
                         (probs, soft, {"use_softmax": False,
                                        "soft_label": True})):
        want = jax_cross_entropy(paddle.to_tensor(inp),
                                 paddle.to_tensor(lab), **kw).numpy()
        got = cross_entropy(torch.from_numpy(inp), torch.from_numpy(lab),
                            **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-6,
                                   err_msg=str(kw))


def test_criterion_matches_jax_with_and_without_mask():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 12, 30)).astype(np.float32)
    labels = rng.integers(0, 30, (2, 12)).astype(np.int32)
    mask = (rng.uniform(size=(2, 12)) > 0.3).astype(np.float32)
    jc, tc = JaxCriterion(), GPTPretrainingCriterion()
    for m in (None, mask):
        want = jc(paddle.to_tensor(logits), paddle.to_tensor(labels),
                  None if m is None else paddle.to_tensor(m)).numpy()
        got = tc(torch.from_numpy(logits), torch.from_numpy(labels),
                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), atol=ATOL)


def test_unported_cross_entropy_kernels_refuse_a_card(monkeypatch):
    """The kernel routes under either flag: a CPU tensor takes the plain
    route (as the JAX package does off the TPU) and loads no kernel; on a
    card, the flag's kernels launch and the loss matches the plain
    route's."""
    def no_library():
        raise AssertionError("the CPU route loaded the CUDA library")
    logits = torch.randn(4, 8, 256, generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 256, (4, 8),
                           generator=torch.Generator().manual_seed(1))
    labels[0, 3] = -100
    want = cross_entropy(logits, labels)
    for flag, counters in (("use_pallas_ce", ("ce_fwd_launches",)),
                           ("use_pallas_lse", ("ce_lse_launches",))):
        monkeypatch.setitem(flags._REGISTRY, flag, True)
        with monkeypatch.context() as m:
            m.setattr(ce_cuda._build, "library", no_library)
            torch.testing.assert_close(cross_entropy(logits, labels), want)
        if torch.cuda.is_available():
            before = [getattr(ce_cuda, c) for c in counters]
            got = cross_entropy(logits.cuda(), labels.cuda())
            assert [getattr(ce_cuda, c) for c in counters] == \
                [b + 1 for b in before]
            torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
        monkeypatch.setitem(flags._REGISTRY, flag, False)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_trainstep_tracks_jax_five_steps(use_kernel, monkeypatch):
    """The gate: five AdamW steps with a global-norm clip, losses per step
    and params after the fifth within 1e-5 of the JAX step."""
    monkeypatch.setitem(flags._REGISTRY, "use_pallas_norm", use_kernel)
    monkeypatch.setitem(jax_flags._REGISTRY, "use_pallas_norm", use_kernel)
    jstep, tstep = _pair(seed=4, wide=use_kernel)
    assert len(tstep.params) == len(jstep.params)
    if use_kernel:
        ln_out = tstep.model.gpt.h[0].ln1(torch.randn(2, 8, 128,
                                                      requires_grad=True))
        # the (rows, F) kernel output, reshaped back to (B, S, F)
        fn = ln_out.grad_fn.next_functions[0][0]
        assert type(fn).__name__ == norm_cuda._LayerNorm.__name__ + "Backward"
    # two batches in turn: the loss must fall
    jl, tl = _run(jstep, tstep, (_batches(2, seed=5) * 3)[:5])
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    assert tl[-1] < tl[0]
    want = _jax_params(jstep)
    got = tstep.state_dict()["params"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL,
                                   rtol=0, err_msg=k)
    # the model's parameters are the masters (f32: the same values)
    for n, p in tstep.model.named_parameters():
        torch.testing.assert_close(p.detach(), got[n], atol=0, rtol=0)


def test_trainstep_tracks_jax_at_the_default_epsilon():
    """AdamW at its default epsilon (1e-8), as bench.py runs it: five
    losses within 1e-5 of the JAX step's, and every parameter after the
    fifth step within 1e-5, except the entries whose gradient is rounding
    noise at every step (not exactly zero, as past-the-batch positions
    are).  Those are Adam's +-lr steps on each side's
    own rounding noise; they must lie in the key third of a qkv bias,
    whose true gradient is zero and which does not move the loss."""
    jstep, tstep = _pair(seed=4, epsilon=1e-8)
    grads = []
    apply = tstep.optimizer.apply_gradients

    def keep(params, g, state, lr):
        grads.append({k: v.clone() for k, v in g.items()})
        return apply(params, g, state, lr)
    tstep.optimizer.apply_gradients = keep
    jl, tl = _run(jstep, tstep, (_batches(2, seed=5) * 3)[:5])
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    assert tl[-1] < tl[0]
    want = _jax_params(jstep)
    got = tstep.state_dict()["params"]
    hidden = tstep.model.gpt.wte.weight.shape[1]
    noise_only = 0
    for k in want:
        # rounding noise: below 1e-6 of the tensor's largest gradient at
        # every step, and not exactly zero at some step
        tiny = torch.stack([g[k].abs() <= 1e-6 * g[k].abs().max()
                            for g in grads])
        noise = tiny.all(0) & torch.stack([g[k] != 0 for g in grads]).any(0)
        if noise.any():
            assert k.endswith("qkv_proj.bias"), k
            assert not noise[:hidden].any() and not noise[2 * hidden:].any()
            noise_only += int(noise.sum())
        keep_ = ~noise.numpy()
        np.testing.assert_allclose(got[k].numpy()[keep_], want[k][keep_],
                                   atol=ATOL, rtol=0, err_msg=k)
    assert noise_only > 0


def test_state_bridge_resumes_a_jax_run():
    """Two JAX steps, the JAX state carried over through the bridge, then
    three more steps on each side with the same losses."""
    jstep, tstep = _pair(seed=6)
    batches = _batches(5, seed=7)
    for ids in batches[:2]:
        jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
    state = jstep.state_dict()
    as_np = {
        "params": {k: np.asarray(v) for k, v in state["params"].items()},
        "buffers": {k: np.asarray(v) for k, v in state["buffers"].items()},
        "opt_state": {
            "slots": {k: {s: np.asarray(a) for s, a in v.items()}
                      for k, v in state["opt_state"]["slots"].items()},
            "step": np.asarray(state["opt_state"]["step"])},
        "opt_extra": state["opt_extra"]}
    tstate = train_state_from_numpy(as_np)
    assert tstate["opt_state"]["step"] == 2
    assert set(tstate["opt_state"]["slots"]["gpt.wte.weight"]) == {
        "moment1", "moment2"}
    tstep.set_state_dict(tstate)
    jl, tl = _run(jstep, tstep, batches[2:])
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    assert tstep.state_dict()["opt_state"]["step"] == 5


def test_trainstep_amp_o2_bf16_tracks_jax():
    """AMP O2: bf16 weights in the model, f32 masters in the step.  Both
    forwards run in bf16, which rounds at other places in the two
    frameworks, so the losses agree to bf16 precision (a few 1e-3 on a
    loss of ~6), not to f32's."""
    jstep, tstep = _pair(seed=8, o2=True)
    for n, p in tstep.model.named_parameters():
        assert p.dtype == (torch.float32 if ".ln" in n else torch.bfloat16)
        assert tstep.params[n].dtype == torch.float32
    jl, tl = _run(jstep, tstep, _batches(1, seed=9) * 3)
    np.testing.assert_allclose(tl, jl, atol=1e-2, rtol=0)
    assert tl[-1] < tl[0]
    # entries whose bf16 gradient is rounding noise take +-lr Adam steps
    # that differ between the two; the typical (median) master agrees to
    # a thirtieth of the 3 * lr the steps moved it
    want = _jax_params(jstep)
    for k, v in tstep.state_dict()["params"].items():
        diff = np.abs(v.numpy() - want[k])
        assert np.median(diff) < 1e-4, (k, np.median(diff))


def test_trainstep_refuses_unported_options():
    tm = GPTForCausalLM(GPTConfig.tiny())
    opt = AdamW(parameters=tm.parameters())
    for kw in ({"zero_stage": 2}, {"stack_layers": True},
               {"in_shardings": [None]}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainStep(tm, GPTPretrainingCriterion(), opt, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GPTForCausalLM(GPTConfig(**dict(_wide_kwargs(), use_recompute=True)))


def test_flat_master_tracks_jax_flat_master(monkeypatch):
    """flat_master=True on both sides, five AdamW steps with a global-norm
    clip: losses and params within 1e-5.  The size cap is lowered on both
    sides so that wte (32768 elements) stays out of the buffer, as
    GPT-2's does at the real cap."""
    monkeypatch.setattr(torch_jit, "_FLAT_MAX_ELEMS", 1 << 15)
    monkeypatch.setattr(jax_jit, "_FLAT_MAX_ELEMS", 1 << 15)
    jstep, tstep = _pair(seed=11, flat_master=True)
    flat = tstep.params[torch_jit._FLAT_KEY]
    assert set(tstep.params) == set(jstep.params) == {
        torch_jit._FLAT_KEY, "gpt.wte.weight"}
    assert flat.numel() == jstep.params[jax_jit._FLAT_KEY].size
    jl, tl = _run(jstep, tstep, (_batches(2, seed=12) * 3)[:5])
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    assert tl[-1] < tl[0]
    want = _jax_params(jstep)
    got = tstep.state_dict()["params"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL,
                                   rtol=0, err_msg=k)
    for n, p in tstep.model.named_parameters():
        torch.testing.assert_close(p.detach(), got[n], atol=0, rtol=0)


def _o2_step(flat_master, seed=13):
    tm = GPTForCausalLM(GPTConfig.tiny(),
                        generator=torch.Generator().manual_seed(seed))
    tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                weight_decay=0.01)
    return TrainStep(tm, GPTPretrainingCriterion(), opt, device="cpu",
                     flat_master=flat_master)


def test_flat_master_state_dict_crosses_both_ways():
    """AMP O2 (a bf16 and an f32 group in the buffer): the flat step takes
    the per-name step's losses, speaks per-name params and slots in its
    state dict, and each step resumes from the other's state dict."""
    flat, per = _o2_step(True), _o2_step(None)
    assert torch_jit._FLAT_KEY in flat.params
    assert torch_jit._FLAT_KEY not in per.params
    assert [buf.dtype for _g0, _g1, buf, _names in flat._flat_groups] == [
        torch.float32, torch.bfloat16]
    batches = _batches(4, seed=14)
    for ids in batches[:3]:
        a = flat(torch.as_tensor(ids), torch.as_tensor(ids))
        b = per(torch.as_tensor(ids), torch.as_tensor(ids))
        # the same elementwise update over the same values
        assert float(a) == float(b)
    sd_flat, sd_per = flat.state_dict(), per.state_dict()
    assert set(sd_flat["params"]) == set(sd_per["params"])
    assert set(sd_flat["opt_state"]["slots"]) == \
        set(sd_per["opt_state"]["slots"])
    for k, v in sd_per["params"].items():
        torch.testing.assert_close(sd_flat["params"][k], v, atol=0, rtol=0)
        for slot, w in sd_per["opt_state"]["slots"][k].items():
            torch.testing.assert_close(
                sd_flat["opt_state"]["slots"][k][slot], w, atol=0, rtol=0)
    re_flat, re_per = _o2_step(True, seed=15), _o2_step(None, seed=15)
    re_flat.set_state_dict(sd_per)
    re_per.set_state_dict(sd_flat)
    ids = torch.as_tensor(batches[3])
    want = float(per(ids, ids))
    assert float(re_flat(ids, ids)) == want == float(re_per(ids, ids))


def test_flat_master_refuses_what_changes_the_math():
    tm = GPTForCausalLM(GPTConfig.tiny())
    for opt in (optimizer.Lamb(parameters=tm.parameters()),
                AdamW(parameters=tm.parameters(),
                      apply_decay_param_fun=lambda n: "bias" not in n),
                AdamW(parameters=tm.parameters(),
                      grad_clip=ClipGradByNorm(1.0))):
        with pytest.raises(ValueError, match="flat_master"):
            TrainStep(tm, GPTPretrainingCriterion(), opt, device="cpu",
                      flat_master=True)
    with pytest.raises(ValueError, match="flat_master"):
        TrainStep(tm, GPTPretrainingCriterion(),
                  AdamW(parameters=tm.parameters()), device="cpu",
                  flat_master=True, zero_stage=2)


def test_train_mode_without_dropout_runs_the_eval_forward():
    tm = GPTForCausalLM(GPTConfig.tiny(),
                        generator=torch.Generator().manual_seed(0))
    ids = torch.randint(0, 512, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    with torch.no_grad():
        tm.eval()
        a = tm(ids)
        tm.train()
        b = tm(ids)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_dropout_masks_follow_the_step_generator():
    """With dropout on, two steps built with one seed take the same
    masks, so the same losses; another seed takes others."""
    cfg = dict(_wide_kwargs(), hidden_dropout_prob=0.1,
               attention_dropout_prob=0.1)

    def losses(seed):
        tm = GPTForCausalLM(GPTConfig(**cfg),
                            generator=torch.Generator().manual_seed(0))
        step = TrainStep(tm, GPTPretrainingCriterion(),
                         AdamW(parameters=tm.parameters()), seed=seed,
                         device="cpu")
        return [float(step(torch.as_tensor(ids), torch.as_tensor(ids)))
                for ids in _batches(2, seed=10)]
    assert losses(3) == losses(3)
    assert losses(3) != losses(4)


def test_long_context_config_builds():
    """max_position_embeddings takes the long-context value the JAX
    package's long-sequence run uses."""
    cfg = GPTConfig(**dict(_wide_kwargs(), max_position_embeddings=16384))
    tm = GPTForCausalLM(cfg)
    assert tm.gpt.wpe.weight.shape == (16384, 128)
