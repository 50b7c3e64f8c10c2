"""The scan-layers GPT (``GPTConfig(scan_layers=True)``: the L blocks as
twelve stacked (L, ...) parameters) against ``paddle_tpu``'s on the CPU
at the tiny config in f32: the forward, five ``TrainStep``s under each
``scan_mode``, and greedy tokens of the paged and slotted engines.  Then
what the port shows alone: a scan model and a per-layer model on the
same weights give the same bits (forward, dropout included, and after
five steps), both state maps round-trip bit for bit, and AMP O2 keeps
the stacked LayerNorm parameters f32.  Weights are numpy arrays from a
seed, loaded into both packages by name."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         per_layer_state_to_scan,
                                         scan_state_to_per_layer)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      DecodeEngine, Request)

# f32 on both sides; the sums run in other orders (XLA vs ATen)
ATOL = 1e-5
FWD_ATOL = 2e-5


def _weights(names_shapes, seed, std=0.05):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in names_shapes:
        if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight",
                          "ln1_w", "ln2_w")):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = std * rng.standard_normal(shape)
        out[name] = a.astype(np.float32)
    return out


def _jax_scan(seed, scan_mode="scan", std=0.05, **cfg):
    jm = JaxGPT(JaxGPTConfig(**dict(dataclasses.asdict(
        JaxGPTConfig.tiny()), scan_layers=True, scan_mode=scan_mode, **cfg)))
    arrays = _weights([(k, tuple(v.shape))
                       for k, v in jm.state_dict().items()], seed, std)
    jm.set_state_dict(arrays)
    return jm, arrays


def _port(arrays, scan_layers=True, **cfg):
    tm = GPTForCausalLM(dataclasses.replace(
        GPTConfig.tiny(), scan_layers=scan_layers, **cfg))
    load_paddle_tpu_state(tm, arrays)
    return tm


def _batches(n, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (b, s)).astype(np.int32) for _ in range(n)]


def _port_step(tm, clip=True, **kw):
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                weight_decay=0.01, epsilon=1e-6,
                grad_clip=ClipGradByGlobalNorm(1.0) if clip else None)
    return TrainStep(tm, GPTPretrainingCriterion(), opt, device="cpu", **kw)


def test_scan_model_forward_matches_jax():
    jm, arrays = _jax_scan(seed=0)
    tm = _port(arrays)
    assert {n for n, _ in tm.named_parameters()} == set(arrays)
    assert tuple(tm.gpt.h_stack.qkv_w.shape) == (2, 64, 192)
    ids = _batches(1, seed=2)[0]
    want = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("scan_mode", ["scan", "stack_vjp"])
def test_scan_model_trainstep_tracks_jax(scan_mode):
    """Five AdamW steps with a global-norm clip: losses per step and the
    stacked parameters after the fifth within 1e-5 of the JAX step."""
    jm, arrays = _jax_scan(seed=3, scan_mode=scan_mode)
    tm = _port(arrays, scan_mode=scan_mode)
    jopt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01,
        epsilon=1e-6, grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jopt)
    tstep = _port_step(tm)
    assert set(tstep.params) == set(jstep.params)
    jl, tl = [], []
    for ids in (_batches(2, seed=4) * 3)[:5]:
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(ids)).numpy()))
        tl.append(float(tstep(torch.as_tensor(ids), torch.as_tensor(ids))))
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    assert tl[-1] < tl[0]
    want = {k: np.asarray(jax.device_get(v), np.float32)
            for k, v in jstep.state_dict()["params"].items()}
    got = tstep.state_dict()["params"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL,
                                   rtol=0, err_msg=k)


def _same_weights_pair(dropout=0.0, **cfg):
    per = GPTForCausalLM(dataclasses.replace(
        GPTConfig.tiny(), hidden_dropout_prob=dropout,
        attention_dropout_prob=dropout, **cfg),
        generator=torch.Generator().manual_seed(5))
    scan = GPTForCausalLM(dataclasses.replace(per.config, scan_layers=True))
    scan.load_state_dict(per_layer_state_to_scan(per.state_dict()))
    return per, scan


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_scan_and_per_layer_models_give_the_same_bits(dropout):
    """The same weights in both layouts: the forward in eval and in train
    mode (dropout masks from one generator, drawn in the same order) and
    the gradients, then five steps of each, compared with torch.equal."""
    per, scan = _same_weights_pair(dropout)
    ids = torch.as_tensor(_batches(1, seed=6)[0])
    outs, grads = [], []
    for m in (per, scan):
        m.eval()
        with torch.no_grad():
            outs.append(m(ids))
        m.train()
        gen = torch.Generator().manual_seed(7)
        for mod in m.modules():
            if hasattr(mod, "generator"):
                mod.generator = gen
        loss = GPTPretrainingCriterion()(m(ids), ids)
        loss.backward()
        outs.append(loss.detach())
        grads.append(per_layer_state_to_scan(
            {n: p.grad for n, p in m.named_parameters()}))
        m.zero_grad()
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
    assert set(grads[0]) == set(grads[1])
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    steps = [_port_step(m, clip=False, seed=8) for m in (per, scan)]
    losses = [[float(s(torch.as_tensor(b), torch.as_tensor(b)))
               for b in _batches(5, seed=9)] for s in steps]
    assert losses[0] == losses[1]
    got = [per_layer_state_to_scan(dict(m.named_parameters()))
           for m in (per, scan)]
    for k in got[0]:
        assert torch.equal(got[0][k], got[1][k]), k


def test_state_maps_round_trip_bitwise():
    per, scan = _same_weights_pair()
    sd = per.state_dict()
    stacked = per_layer_state_to_scan(sd)
    assert set(stacked) == set(scan.state_dict())
    assert tuple(stacked["gpt.h_stack.fc1_w"].shape) == (2, 64, 128)
    back = scan_state_to_per_layer(stacked)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    as_np = {k: v.numpy() for k, v in sd.items()}
    stacked_np = per_layer_state_to_scan(as_np)
    for k, v in stacked_np.items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, stacked[k].numpy())
    for k, v in scan_state_to_per_layer(stacked_np).items():
        np.testing.assert_array_equal(v, as_np[k])
    bad = dict(sd)
    del bad["gpt.h.0.ln1.weight"]
    with pytest.raises(ValueError, match="gaps"):
        per_layer_state_to_scan(bad)


def test_amp_o2_keeps_the_stacked_layer_norm_parameters_f32():
    _per, scan = _same_weights_pair()
    scan = amp.decorate(scan, level="O2", dtype="bfloat16")
    for n, p in scan.named_parameters():
        ln = n.endswith(("ln1_w", "ln1_b", "ln2_w", "ln2_b")) or ".ln_f." in n
        assert p.dtype == (torch.float32 if ln else torch.bfloat16), n


def test_scan_config_checks_and_initializers():
    # any scan_mode is taken, as in JAX (which reads all but "stack_vjp"
    # as "scan"), and changes nothing
    ids = torch.as_tensor(_batches(1, seed=9)[0])
    outs = []
    for mode in ("scan", "stack_vjp", "unrolled"):
        m = GPTForCausalLM(dataclasses.replace(
            GPTConfig.tiny(), scan_layers=True, scan_mode=mode),
            generator=torch.Generator().manual_seed(1))
        outs.append(m(ids))
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    cfg = dataclasses.replace(GPTConfig.tiny(), num_hidden_layers=8,
                              hidden_size=128, intermediate_size=512,
                              scan_layers=True, scan_unroll=8)
    m = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    hs = m.gpt.h_stack
    std = cfg.initializer_range
    for name, want in (("qkv_w", std), ("fc1_w", std),
                       ("out_w", std / 4.0), ("fc2_w", std / 4.0)):
        got = float(getattr(hs, name).std())
        assert abs(got - want) < 0.05 * want, (name, got, want)
    for name in ("ln1_w", "ln2_w"):
        assert torch.equal(getattr(hs, name), torch.ones_like(
            getattr(hs, name)))
    for name in ("ln1_b", "ln2_b", "qkv_b", "out_b", "fc1_b", "fc2_b"):
        assert not getattr(hs, name).any(), name


def _serve(sched_cls, req_cls, eng, prompts, **kw):
    sched = sched_cls(eng, **kw)
    rids = [sched.submit(req_cls(prompt=p.copy(), max_new_tokens=8,
                                 temperature=0.0)) for p in prompts]
    res = sched.run()
    return [res[r].tokens.tolist() for r in rids]


@pytest.mark.parametrize("paged", [True, False])
def test_scan_model_engines_give_jax_greedy_tokens(paged):
    """Five prompts through two slots (churn), greedy: the port's engine
    on its scan model gives the JAX scan model engine's tokens."""
    jm, arrays = _jax_scan(seed=10, std=0.2)
    jm.eval()
    tm = _port(arrays)
    tm.eval()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, (int(rng.integers(12, 40)),))
               .astype(np.int32) for _ in range(5)]
    kw = dict(num_slots=2, max_len=64, paged=paged)
    if paged:
        kw["page_size"] = 8
    want = _serve(JaxScheduler, JaxRequest, JaxEngine(jm, seed=0, **kw),
                  prompts, overlap=False)
    got = _serve(ContinuousBatchingScheduler, Request,
                 DecodeEngine(tm, seed=0, device="cpu", **kw), prompts)
    assert got == want
    assert len({tuple(t) for t in got}) > 1
