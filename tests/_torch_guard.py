"""Shared by the port's training-guard parity tests: the tiny GPT (two
layers, hidden 64) in both packages on one set of seeded numpy weights,
each wrapped in its package's ``TrainStep`` with AdamW, and seeded
batches of (ids, labels, f32 loss mask)."""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTPretrainingCriterion)
from paddle_tpu_torch.optimizer import AdamW

VOCAB = 512
# f32 on both sides; the sums run in other orders (XLA vs ATen)
ATOL = 1e-5


def weights(jm, seed):
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


def models(seed=0, dropout=0.0):
    """(jax model, port model) on the same weights; the port model's
    dropout at ``dropout`` (the JAX model's stays 0: its masks never match
    the port's)."""
    jm = JaxGPT(JaxGPTConfig.tiny())
    arrays = weights(jm, seed)
    jm.set_state_dict(arrays)
    cfg = GPTConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = dropout
    tm = GPTForCausalLM(cfg)
    load_paddle_tpu_state(tm, arrays)
    return jm, tm


def jax_opt(jm, lr=1e-3):
    # epsilon 1e-6 on both sides: the key bias's true gradient is zero
    return paddle.optimizer.AdamW(learning_rate=lr,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01, epsilon=1e-6)


def port_opt(tm, lr=1e-3):
    return AdamW(learning_rate=lr, parameters=tm.parameters(),
                 weight_decay=0.01, epsilon=1e-6)


def steps(seed=0, dropout=0.0, lr=1e-3):
    """(jax TrainStep, port TrainStep) over the same weights."""
    jm, tm = models(seed, dropout)
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb, m: jcrit(lg, lb, m),
                         jax_opt(jm, lr))
    tstep = TrainStep(tm, GPTPretrainingCriterion(), port_opt(tm, lr),
                      device="cpu")
    return jstep, tstep


def batches(n, b=2, s=16, seed=1):
    """``n`` (ids, labels, loss_mask f32) numpy batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
        out.append((ids, ids.copy(), np.ones((b, s), np.float32)))
    return out


def jax_batch(batch):
    return tuple(paddle.to_tensor(a) for a in batch)


def port_batch(batch):
    return tuple(torch.as_tensor(a) for a in batch)
