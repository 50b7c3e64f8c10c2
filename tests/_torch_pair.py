"""Shared by the port's serving-tier parity tests: the tiny GPT in both
packages on one set of seeded numpy weights (f32, dropout 0), and a
greedy drive through either package's scheduler."""
import numpy as np

from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

VOCAB = 512


def pair(seed=0, std=0.2):
    """(jax model, port model) on the same weights, wider than the 0.02
    initializer so that greedy tokens vary."""
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.eval()
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in jm.state_dict().items():
        base = 1.0 if k.endswith(("ln1.weight", "ln2.weight",
                                  "ln_f.weight")) else 0.0
        scale = 0.1 if base else std
        arrays[k] = (base + scale * rng.standard_normal(tuple(v.shape))
                     ).astype(np.float32)
    jm.set_state_dict(arrays)
    tm = GPTForCausalLM(GPTConfig.tiny())
    load_paddle_tpu_state(tm, arrays)
    tm.eval()
    return jm, tm


def prompts(n=4, seed=0, plen=(20, 48)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (int(rng.integers(*plen)),))
            .astype(np.int32) for _ in range(n)]


def drive(sched, req_cls, ps, max_new=6, eos=None):
    """Submit ``ps`` greedy to ``sched`` and run it; returns the token
    tuples in submission order and the results by rid."""
    rids = [sched.submit(req_cls(prompt=p.copy(), max_new_tokens=max_new,
                                 temperature=0.0, eos_token_id=eos))
            for p in ps]
    res = sched.run()
    return [tuple(int(t) for t in res[r].tokens) for r in rids], res
