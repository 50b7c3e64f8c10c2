"""paddle_tpu_torch.nn's default initializers and ``Embedding``'s
``padding_idx`` against the reference: ``Linear`` and ``Embedding`` draw
XavierNormal weights (std = gain * sqrt(2 / (fan_in + fan_out))) and zero
biases, as ``paddle_tpu``'s do; ``padding_idx`` zeroes its row and the
lookups of it, a negative index counting from the end; and the GPT
model's weights drawn from an explicit generator are the bits they were
before the layers drew defaults of their own."""
import hashlib
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import Embedding, Linear
from paddle_tpu_torch.nn import initializer as I


def test_linear_default_weight_is_xavier_normal_and_bias_zero():
    lin = Linear(512, 1024)
    std = float(lin.weight.detach().std())
    want = math.sqrt(2.0 / (512 + 1024))
    assert abs(std - want) / want < 0.05
    assert abs(float(lin.weight.detach().mean())) < 0.05 * want
    assert lin.weight.shape == (512, 1024)
    assert lin.bias.shape == (1024,) and not bool(lin.bias.any())
    assert Linear(4, 8, bias_attr=False).bias is None


def test_linear_and_embedding_stds_match_paddle_tpu():
    """The reference's draw at the same shape has the same std, to the
    sampling error of ~500k draws."""
    jl = paddle.nn.Linear(512, 1024)
    je = paddle.nn.Embedding(1000, 256)
    tl, te = Linear(512, 1024), Embedding(1000, 256)
    for j, t in ((jl.weight, tl.weight), (je.weight, te.weight)):
        js, ts = float(np.std(j.numpy())), float(t.detach().std())
        assert abs(js - ts) / js < 0.02, (js, ts)
    assert not np.asarray(jl.bias.numpy()).any()


def test_initializers_draw_from_the_given_generator():
    a = I.XavierNormal()((64, 32), generator=torch.Generator().manual_seed(3))
    b = I.XavierNormal()((64, 32), generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    n = I.Normal(1.0, 0.5)((20000,), generator=torch.Generator().manual_seed(4))
    assert abs(float(n.mean()) - 1.0) < 0.02
    assert abs(float(n.std()) - 0.5) < 0.02
    c = I.Constant(2.5)((3, 2), dtype="bfloat16")
    assert c.dtype == torch.bfloat16 and bool((c == 2.5).all())
    torch.manual_seed(5)
    lin = Linear(8, 4)
    torch.manual_seed(5)
    again = Linear(8, 4)
    assert torch.equal(lin.weight, again.weight)


@pytest.mark.parametrize("padding_idx", [0, 3, -1, -2])
def test_embedding_padding_idx_matches_paddle_tpu(padding_idx):
    """The same numpy table loaded into both: outputs agree, the padding
    row's lookups are zeros, and a fresh table starts with that row
    zeroed."""
    n, d = 10, 6
    je = paddle.nn.Embedding(n, d, padding_idx=padding_idx)
    te = Embedding(n, d, padding_idx=padding_idx)
    row = padding_idx % n
    assert te.padding_idx == je.padding_idx == row
    assert not bool(te.weight[row].any())
    assert not np.asarray(je.weight.numpy()[row]).any()
    table = np.random.default_rng(1).standard_normal((n, d)).astype(
        np.float32)
    je.weight.set_value(table)
    with torch.no_grad():
        te.weight.copy_(torch.from_numpy(table))
    ids = np.asarray([[0, 3, 9, 8], [row, 2, row, 5]], np.int32)
    want = je(paddle.to_tensor(ids)).numpy()
    got = te(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1, 0].any() and not got[1, 2].any()


def test_gpt_weights_from_a_generator_are_unchanged():
    """``_init_weights`` redraws every weight matrix from the model's own
    generator after the layers drew their defaults from the global one,
    so a model built with a generator holds the same bits as before the
    defaults were added (this digest)."""
    m = GPTForCausalLM(GPTConfig.tiny(),
                       generator=torch.Generator().manual_seed(0))
    h = hashlib.sha256()
    for k, v in m.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().numpy().tobytes())
    assert h.hexdigest() == (
        "6ccd88258d9e42b69a0e41384c8f24eda268fe53524743a92299feb3c5d723d5")
    for name, p in m.named_parameters():
        if name.endswith(".bias"):
            assert not bool(p.any()), name
