"""``jit.TrainStep(stack_layers=True)`` against ``paddle_tpu``'s on the
CPU at the tiny GPT in f32: five AdamW steps with a global-norm clip.
Then what the port shows alone: the stacked step takes the per-layer
step's bits, its state dict speaks per-layer names for params and
slots and loads across the modes (a JAX stacked step's state too, through
``convert.train_state_from_numpy``), under AMP O2 the model's parameters
are views of one bf16 buffer a template whose write-back a serving
engine's prefix-cache purge sees, and ``flat_master`` with
``stack_layers`` raises."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import (load_paddle_tpu_state,
                                      train_state_from_numpy)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from test_torch_paged import _assert_step_purges_prefix_cache, _prompt
from test_torch_paged import _pair as _serving_pair
from test_torch_train import ATOL, _batches, _jax_params, _run, _weights

#: the 12 per-layer parameters of a GPT block, stacked over L
_TEMPLATES = 12


def _jax_pair(seed, stack_layers=True):
    jm = JaxGPT(JaxGPTConfig.tiny())
    arrays = _weights(jm, seed)
    jm.set_state_dict(arrays)
    tm = GPTForCausalLM(GPTConfig.tiny())
    load_paddle_tpu_state(tm, arrays)
    jopt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01,
        epsilon=1e-6, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jopt,
                         stack_layers=stack_layers)
    tstep = TrainStep(tm, GPTPretrainingCriterion(),
                      AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                            weight_decay=0.01, epsilon=1e-6,
                            grad_clip=ClipGradByGlobalNorm(1.0)),
                      device="cpu", stack_layers=stack_layers)
    return jstep, tstep


def test_stacked_trainstep_tracks_jax():
    """Five steps: the step state holds the JAX step's stacked names,
    and losses and every parameter after the fifth step are within 1e-5
    of the JAX step's."""
    jstep, tstep = _jax_pair(seed=20)
    assert set(tstep.params) == set(jstep.params)
    templates = [k for k in tstep.params if ".#." in k]
    assert len(templates) == _TEMPLATES
    assert tuple(tstep.params["gpt.h.#.attn.qkv_proj.weight"].shape) == \
        (2, 64, 192)
    jl, tl = _run(jstep, tstep, (_batches(2, seed=21) * 3)[:5])
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


def _o2_step(stack_layers, seed=22):
    tm = GPTForCausalLM(GPTConfig.tiny(),
                        generator=torch.Generator().manual_seed(seed))
    tm = amp.decorate(tm, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                weight_decay=0.01)
    return TrainStep(tm, GPTPretrainingCriterion(), opt, device="cpu",
                     stack_layers=stack_layers)


def test_stacked_step_takes_the_per_layer_steps_bits():
    """AMP O2, AdamW (elementwise, no clip): the same losses and the same
    masters, slots and bf16 model parameters as the per-layer step."""
    stacked, per = _o2_step(True), _o2_step(False)
    for ids in _batches(4, seed=23):
        a = stacked(torch.as_tensor(ids), torch.as_tensor(ids))
        b = per(torch.as_tensor(ids), torch.as_tensor(ids))
        assert float(a) == float(b)
    sd_s, sd_p = stacked.state_dict(), per.state_dict()
    assert set(sd_s["params"]) == set(sd_p["params"])
    assert set(sd_s["opt_state"]["slots"]) == set(sd_p["opt_state"]["slots"])
    for k, v in sd_p["params"].items():
        assert torch.equal(sd_s["params"][k], v), k
        for slot, w in sd_p["opt_state"]["slots"][k].items():
            assert torch.equal(sd_s["opt_state"]["slots"][k][slot], w), k
    mp = dict(per.model.named_parameters())
    for n, p in stacked.model.named_parameters():
        assert p.dtype == mp[n].dtype and torch.equal(p, mp[n]), n


def test_stacked_model_parameters_view_one_buffer_a_template():
    """Under AMP O2 each template's members are views of one (L, ...)
    buffer in their compute dtype (bf16, LayerNorm f32), which the
    write-back fills with one cast; each member's version moves."""
    step = _o2_step(True)
    assert len(step._stack_bufs) == _TEMPLATES
    params = dict(step.model.named_parameters())
    for template, names in step._stack.items():
        buf = step._stack_bufs[template]
        assert buf.shape[0] == len(names) == 2
        want = torch.float32 if ".ln" in template else torch.bfloat16
        assert buf.dtype == want and step.params[template].dtype == \
            torch.float32
        for i, n in enumerate(names):
            assert params[n].data_ptr() == buf[i].data_ptr()
    versions = {n: p._version for n, p in params.items()}
    ids = torch.as_tensor(_batches(1, seed=24)[0])
    step(ids, ids)
    for n in step._stack["gpt.h.#.attn.qkv_proj.weight"]:
        assert params[n]._version > versions[n]
        assert params[n].data_ptr() == step._stack_bufs[
            "gpt.h.#.attn.qkv_proj.weight"][int(n.split(".")[2])].data_ptr()


def test_stacked_state_dict_crosses_the_modes():
    """Each step resumes from the other's state dict and the next loss is
    the same, bit for bit."""
    stacked, per = _o2_step(True), _o2_step(False)
    batches = _batches(3, seed=25)
    for ids in batches[:2]:
        stacked(torch.as_tensor(ids), torch.as_tensor(ids))
        per(torch.as_tensor(ids), torch.as_tensor(ids))
    re_stacked, re_per = _o2_step(True, seed=26), _o2_step(False, seed=26)
    re_stacked.set_state_dict(per.state_dict())
    re_per.set_state_dict(stacked.state_dict())
    ids = torch.as_tensor(batches[2])
    want = float(per(ids, ids))
    assert float(re_stacked(ids, ids)) == want == float(re_per(ids, ids))


def test_jax_stacked_state_resumes_through_the_bridge():
    """Two JAX stacked steps, their state carried over (per-layer names,
    as the JAX step exports it), then three more steps on each side."""
    jstep, tstep = _jax_pair(seed=27)
    batches = _batches(5, seed=28)
    for ids in batches[:2]:
        jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))
    state = jstep.state_dict()
    assert "gpt.h.1.mlp.fc1.weight" in state["params"]
    as_np = {
        "params": {k: np.asarray(v) for k, v in state["params"].items()},
        "buffers": {k: np.asarray(v) for k, v in state["buffers"].items()},
        "opt_state": {
            "slots": {k: {s: np.asarray(a) for s, a in v.items()}
                      for k, v in state["opt_state"]["slots"].items()},
            "step": np.asarray(state["opt_state"]["step"])},
        "opt_extra": state["opt_extra"]}
    tstep.set_state_dict(train_state_from_numpy(as_np))
    jl, tl = _run(jstep, tstep, batches[2:])
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)


def test_flat_master_with_stack_layers_raises():
    tm = GPTForCausalLM(GPTConfig.tiny())
    with pytest.raises(ValueError, match="flat_master"):
        TrainStep(tm, GPTPretrainingCriterion(),
                  AdamW(parameters=tm.parameters()), device="cpu",
                  flat_master=True, stack_layers=True)


def test_stacked_train_step_between_generates_never_serves_stale_prefix():
    """The stacked write-back goes through the buffer the parameters
    view, so it bumps their versions itself: the engine's purge sees the
    step."""
    _jm, tm = _serving_pair(seed=16)
    ids = torch.from_numpy(_prompt(3, 32)[None].astype(np.int64))
    train = TrainStep(tm, GPTPretrainingCriterion(),
                      AdamW(learning_rate=1e-2, parameters=tm.parameters()),
                      stack_layers=True, device="cpu")
    assert train._stack
    _assert_step_purges_prefix_cache(tm, lambda: train(ids, ids))
