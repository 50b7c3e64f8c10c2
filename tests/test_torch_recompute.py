"""Activation recompute (``distributed.recompute`` and
``GPTConfig(use_recompute=True)``) on the CPU: a ``TrainStep`` with
recompute hands the optimizer the same gradients as one without, bit for
bit, per layer and in the scan layout, at dropout 0 and at dropout 0.1
(the second run of each block draws the forward's masks from the step's
generator, and leaves the generator where the run without recompute
leaves it); the block's activations are dropped in the forward and made
again in the backward; the parameters of a block whose input needs no
gradient get theirs; a closure over a block, which exposes no modules,
redraws its forward's masks too; and the losses track ``paddle_tpu``'s
``use_recompute=True`` model, both layouts."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import recompute, recompute_sequential
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         per_layer_state_to_scan)
from paddle_tpu_torch.nn.layer.common import Dropout, Linear
from paddle_tpu_torch.optimizer import AdamW

ATOL = 1e-5


def _batches(n, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (b, s)).astype(np.int32) for _ in range(n)]


def _step(use_recompute, scan_layers, dropout, seed=0):
    cfg = dataclasses.replace(GPTConfig.tiny(), hidden_dropout_prob=dropout,
                              attention_dropout_prob=dropout)
    per = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(30))
    model = GPTForCausalLM(dataclasses.replace(
        cfg, use_recompute=use_recompute, scan_layers=scan_layers))
    sd = per.state_dict()
    model.load_state_dict(per_layer_state_to_scan(sd) if scan_layers
                          else sd)
    step = TrainStep(model, GPTPretrainingCriterion(),
                     AdamW(learning_rate=1e-3, parameters=model.parameters(),
                           weight_decay=0.01), device="cpu", seed=seed)
    grads = []
    apply = step.optimizer.apply_gradients

    def keep(params, g, state, lr):
        grads.append({k: v.clone() for k, v in g.items()})
        return apply(params, g, state, lr)
    step.optimizer.apply_gradients = keep
    return step, grads


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("scan_layers", [False, True])
def test_recompute_gives_the_same_gradients(scan_layers, dropout):
    """Three steps each way from the same weights and seed: equal losses,
    gradients and generator states after every step."""
    runs = []
    for use in (False, True):
        step, grads = _step(use, scan_layers, dropout, seed=31)
        losses, states = [], []
        for ids in _batches(3, seed=32):
            losses.append(float(step(torch.as_tensor(ids),
                                     torch.as_tensor(ids))))
            states.append(step.generator.get_state())
        runs.append((losses, grads, states))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1
    for a, b in zip(g0, g1):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)
    if dropout:
        # the masks came from the step's generator: another seed moves
        # the loss
        other, _ = _step(True, scan_layers, dropout, seed=33)
        ids = torch.as_tensor(_batches(1, seed=32)[0])
        assert float(other(ids, ids)) != l1[0]


class _Counting(torch.nn.Module):
    """Two Linears with dropout between them, counting its forwards."""

    def __init__(self):
        super().__init__()
        self.a = Linear(8, 8)
        self.drop = Dropout(0.5)
        self.b = Linear(8, 8)
        self.calls = 0

    def forward(self, x):
        self.calls += 1
        return self.b(self.drop(torch.tanh(self.a(x))))


def test_recompute_reruns_the_block_and_reaches_its_parameters():
    """The input needs no gradient, yet the parameters get the plain
    run's; the block runs twice; the generator after the backward is
    where the forward left it."""
    torch.manual_seed(0)
    block = _Counting()
    gen = torch.Generator().manual_seed(4)
    block.drop.generator = gen
    x = torch.randn(3, 8)
    start = gen.get_state()
    plain = block(x).square().sum()
    plain.backward()
    want = {n: p.grad.clone() for n, p in block.named_parameters()}
    left = gen.get_state()
    block.zero_grad()
    gen.set_state(start)
    block.calls = 0
    out = recompute(block, x, use_reentrant=True)
    assert torch.equal(gen.get_state(), left)
    assert torch.equal(out.square().sum(), plain)
    out.square().sum().backward()
    assert block.calls == 2
    assert torch.equal(gen.get_state(), left)
    for n, p in block.named_parameters():
        assert torch.equal(p.grad, want[n]), n


def test_recompute_of_a_closure_redraws_the_forward_masks():
    """A closure over a GPT block (no ``modules()`` of its own) at
    dropout 0.1, its masks (attention and residual) drawn from one
    explicit generator: the re-run in the backward draws the forward's
    masks, so output, input and parameter gradients equal the plain
    run's, and the generator ends where the plain run left it."""
    cfg = dataclasses.replace(GPTConfig.tiny(), hidden_dropout_prob=0.1,
                              attention_dropout_prob=0.1)
    block = GPTForCausalLM(
        cfg, generator=torch.Generator().manual_seed(5)).gpt.h[0]
    block.train()
    gen = torch.Generator().manual_seed(6)
    for m in block.modules():
        if hasattr(m, "generator"):
            m.generator = gen
    x0 = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (2, 16, cfg.hidden_size)).astype(np.float32))
    start = gen.get_state()
    runs = []
    for use in (False, True):
        gen.set_state(start)
        block.zero_grad()
        x = x0.clone().requires_grad_(True)
        out = (recompute(lambda h: block(h), x) if use else block(x))
        out.square().sum().backward()
        runs.append((out.detach(), x.grad,
                     {n: p.grad.clone() for n, p in block.named_parameters()},
                     gen.get_state()))
    (o0, dx0, g0, s0), (o1, dx1, g1, s1) = runs
    assert torch.equal(o0, o1)
    assert torch.equal(dx0, dx1)
    assert torch.equal(s0, s1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    # the masks matter: another stream moves the output
    gen.manual_seed(8)
    assert not torch.equal(block(x0), o0)


def test_recompute_sequential_matches_the_plain_chain():
    torch.manual_seed(1)
    layers = [Linear(8, 8), torch.nn.Tanh(), Linear(8, 8), torch.nn.Tanh()]
    x = torch.randn(4, 8, requires_grad=True)
    want = torch.nn.Sequential(*layers)(x).sum()
    want.backward()
    grads = [p.grad.clone() for layer in layers
             for p in layer.parameters()] + [x.grad.clone()]
    for layer in layers:
        layer.zero_grad()
    x.grad = None
    got = recompute_sequential(torch.nn.Sequential(*layers), x, segments=2)
    got.sum().backward()
    assert torch.equal(got.sum(), want)
    for a, b in zip([p.grad for layer in layers
                     for p in layer.parameters()] + [x.grad], grads):
        assert torch.equal(a, b)


def test_recompute_keeps_fewer_activations():
    """The tensors autograd holds for the backward (saved-tensor hooks):
    with recompute, only each block's input stays, not its inside."""
    def saved(use):
        step, _ = _step(use, False, 0.0)
        model = step.model
        model.train()
        ids = torch.as_tensor(_batches(1, seed=34)[0])
        count = [0]

        def pack(t):
            count[0] += 1
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(ids)
        return count[0]
    assert saved(True) < saved(False) / 2


@pytest.mark.parametrize("scan_layers", [False, True])
def test_recompute_losses_track_jax(scan_layers):
    """Three AdamW steps of the ``use_recompute=True`` model on both
    sides (JAX: ``jax.checkpoint``), dropout 0: losses within 1e-5."""
    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), use_recompute=True,
                               scan_layers=scan_layers)
    jm = JaxGPT(jcfg)
    rng = np.random.default_rng(35)
    arrays = {k: (1.0 + 0.1 * rng.standard_normal(tuple(v.shape))
                  if k.endswith(("ln1.weight", "ln2.weight", "ln_f.weight",
                                 "ln1_w", "ln2_w"))
                  else 0.05 * rng.standard_normal(tuple(v.shape))
                  ).astype(np.float32)
              for k, v in jm.state_dict().items()}
    jm.set_state_dict(arrays)
    tm = GPTForCausalLM(dataclasses.replace(
        GPTConfig.tiny(), use_recompute=True, scan_layers=scan_layers))
    load_paddle_tpu_state(tm, arrays)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01, epsilon=1e-6)
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jopt)
    tstep = TrainStep(tm, GPTPretrainingCriterion(),
                      AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                            weight_decay=0.01, epsilon=1e-6), device="cpu")
    jl, tl = [], []
    for ids in _batches(1, seed=36) * 3:
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(ids)).numpy()))
        tl.append(float(tstep(torch.as_tensor(ids), torch.as_tensor(ids))))
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    assert tl[-1] < tl[0]
