"""The port's activations, ``paddle_tpu_torch.nn`` exports and
``GPTForCausalLM.generate`` against the JAX package on the same numpy
inputs:

* every deterministic activation of ``nn.functional`` (the JAX
  package's ``activation.py``, its default arguments): values and the
  gradients of a weighted sum, f32, to 1e-6; ``gumbel_softmax`` and
  ``rrelu`` (their noise from a ``torch.Generator``) for shape, range and
  determinism under a seed;
* ``ExpertFFN(activation="relu" | "silu")`` with the JAX expert's
  weights, and ``moe_apply(act="relu" | "silu" | "swish")``: out and
  grads to 1e-5;
* ``paddle_tpu_torch.nn.DataParallel`` is the distributed one;
* ``GPTForCausalLM.generate``'s greedy tokens on the tiny GPT equal the
  JAX model's ``generate`` for a 2-D batch and ragged prompts, with
  ``greedy=True`` and with ``temperature=0``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn.functional import activation as jact
from paddle_tpu_torch.convert import load_paddle_tpu_state
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn.functional import activation as tact

TOL = 1e-6


def _input(shape=(4, 6, 8), seed=31):
    """Normal values of scale 3, and +-30 in a few places: softplus's
    threshold branch and the saturating ones."""
    x = (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)
    x.reshape(-1)[::29] = 30.0
    x.reshape(-1)[7::31] = -30.0
    return x


#: (name, extra positional numpy args, keyword args): every deterministic
#: activation; maxout / glu / prelu on the shapes they need
CASES = [(n, (), {}) for n in (
    "relu", "relu6", "elu", "selu", "celu", "silu", "swish", "mish",
    "sigmoid", "hardsigmoid", "hardswish", "hardtanh", "hardshrink",
    "softshrink", "tanhshrink", "leaky_relu", "log_sigmoid", "softplus",
    "softsign", "tanh", "thresholded_relu", "softmax", "log_softmax",
    "gelu", "glu")] + [
    ("gelu", (), {"approximate": True}),
    ("softmax", (), {"axis": 1}),
    ("log_softmax", (), {"axis": 0}),
    ("elu", (), {"alpha": 0.5}),
    ("leaky_relu", (), {"negative_slope": 0.2}),
    ("softplus", (), {"beta": 2.0, "threshold": 10.0}),
    ("maxout", (), {"groups": 2}),
    ("rrelu", (), {"training": False}),
    ("prelu", (np.linspace(0.05, 0.4, 6, dtype=np.float32),), {}),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=["%s%s" % (c[0], "-" + "-".join(
                             "%s=%s" % i for i in c[2].items())
                             if c[2] else "") for c in CASES])
def test_activation_matches_jax(name, args, kw):
    x = _input()
    jfn = getattr(jact, name).raw
    tfn = getattr(tact, name)
    jout = jfn(jnp.asarray(x), *(jnp.asarray(a) for a in args), **kw)
    w = np.random.RandomState(32).randn(*jout.shape).astype(np.float32)

    def jloss(*xs):
        return jnp.sum(jfn(*xs, **kw) * w)
    jgrads = jax.grad(jloss, argnums=tuple(range(1 + len(args))))(
        jnp.asarray(x), *(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in (x,) + args]
    out = tfn(*ts, **kw)
    assert out.dtype == torch.float32 and tuple(out.shape) == jout.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL)


def test_every_jax_activation_is_exported():
    """The names JAX's ``nn.functional`` star-imports from its
    ``activation.py`` are all in the port's ``nn.functional``, with JAX's
    default arguments."""
    import inspect

    from paddle_tpu_torch.nn import functional as F
    jnames = [n for n in dir(jact) if not n.startswith("_")
              and callable(getattr(jact, n))
              and hasattr(getattr(jact, n), "raw")]
    assert len(jnames) == 29
    for n in jnames:
        assert getattr(F, n) is getattr(tact, n), n
        jsig = inspect.signature(getattr(jact, n).raw).parameters
        tsig = inspect.signature(getattr(tact, n)).parameters
        for p, v in jsig.items():
            if v.default is not inspect.Parameter.empty:
                assert tsig[p].default == v.default, (n, p)


@pytest.mark.parametrize("fn", ["gumbel_softmax", "rrelu"])
def test_random_activations_draw_from_the_generator(fn):
    x = torch.from_numpy(_input())

    def run(seed, **kw):
        return getattr(tact, fn)(x, generator=torch.Generator()
                                 .manual_seed(seed), **kw)
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == x.shape
    if fn == "gumbel_softmax":
        assert torch.allclose(a.sum(-1), torch.ones(()), atol=1e-5)
        assert bool((a >= 0).all()) and bool((a <= 1).all())
        hard = run(0, hard=True)
        # the one-hot of the soft sample's argmax, up to the rounding of
        # hard + y - y (the straight-through sum, as in JAX)
        onehot = torch.zeros_like(a).scatter(-1, a.argmax(-1, True), 1.0)
        assert float((hard - onehot).abs().max()) <= 1e-6
    else:
        neg = x < 0
        slope = a[neg] / x[neg]
        assert bool((slope >= 1 / 8).all()) and bool((slope < 1 / 3).all())
        assert torch.equal(a[~neg], x[~neg])
        mean = tact.rrelu(x, training=False)
        assert torch.equal(mean[neg], x[neg] * (1 / 8 + 1 / 3) / 2)


@pytest.mark.parametrize("act", ["relu", "silu"])
def test_expert_ffn_activation_matches_jax(act):
    paddle.seed(3)
    jl = jmoe.ExpertFFN(8, 16, activation=act)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    x = np.random.RandomState(33).randn(5, 8).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    # the JAX package's one recording switch, on for the call whatever an
    # earlier test in this process left it at
    with paddle.set_grad_enabled(True):
        jout = jl(jx)
        jout.sum().backward()
    tl = tmoe.ExpertFFN(8, 16, activation=act)
    tl.load_state_dict({k: torch.from_numpy(v.copy())
                        for k, v in state.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tl(tx)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jout.numpy()), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=1e-5, atol=1e-5)
    for n, p in jl.named_parameters():
        np.testing.assert_allclose(dict(tl.named_parameters())[n].grad
                                   .numpy(), np.asarray(p.grad.numpy()),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["relu", "silu", "swish"])
def test_moe_apply_activation_matches_jax(act):
    rng = np.random.RandomState(34)
    params = {"gate": (rng.randn(16, 4) * 0.5).astype(np.float32),
              "w1": (rng.randn(4, 16, 32) * 0.2).astype(np.float32),
              "b1": (rng.randn(4, 32) * 0.1).astype(np.float32),
              "w2": (rng.randn(4, 32, 16) * 0.2).astype(np.float32),
              "b2": (rng.randn(4, 16) * 0.1).astype(np.float32)}
    x = rng.randn(2, 8, 16).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def jloss(p):
        out, aux = jmoe.moe_apply(p, jnp.asarray(x), top_k=2,
                                  capacity_factor=2.0, act=act)
        return jnp.mean(out ** 2) + 0.01 * aux, out
    (_jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    out, aux = tmoe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                              capacity_factor=2.0, act=act)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    gs = torch.autograd.grad(torch.mean(out ** 2) + 0.01 * aux,
                             list(tp.values()))
    for name, g in zip(tp, gs):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", sorted(tmoe._ACTS))
def test_moe_apply_activation_names_are_jax_nn(act):
    """Each name ``moe_apply`` takes computes ``jax.nn``'s function of that
    name (its defaults): values to 1e-6 and gradients of a weighted sum
    (weights up to 3) to rtol 1e-6, atol 2e-6, in f32: PyTorch's
    tanh-GELU backward is its own f32 formula, up to 1.3e-6 from JAX's
    autodiff of the forward here."""
    x = _input()
    w = np.random.RandomState(36).randn(*x.shape).astype(np.float32)
    jfn = getattr(jax.nn, act)
    jy, jvjp = jax.vjp(jfn, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tmoe._ACTS[act](xt)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(w))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jvjp(jnp.asarray(w))[0]),
                               rtol=TOL, atol=2e-6)


def test_moe_apply_refuses_an_unknown_activation():
    p = {"gate": torch.zeros(4, 2), "w1": torch.zeros(2, 4, 8),
         "b1": torch.zeros(2, 8), "w2": torch.zeros(2, 8, 4),
         "b2": torch.zeros(2, 4)}
    with pytest.raises(ValueError, match="jax.nn"):
        tmoe.moe_apply(p, torch.zeros(1, 4, 4), act="no_such_act")


def test_data_parallel_is_exported_from_nn():
    from paddle_tpu_torch import distributed, nn
    assert nn.DataParallel is distributed.DataParallel
    assert "DataParallel" in nn.__all__


def _gpt_pair(seed=0, std=0.2):
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.eval()
    rng = np.random.default_rng(seed)
    arrays = {}
    for k, v in jm.state_dict().items():
        base = 1.0 if k.endswith(("ln1.weight", "ln2.weight",
                                  "ln_f.weight")) else 0.0
        arrays[k] = (base + (0.1 if base else std) * rng.standard_normal(
            tuple(v.shape))).astype(np.float32)
    jm.set_state_dict(arrays)
    tm = GPTForCausalLM(GPTConfig.tiny())
    load_paddle_tpu_state(tm, arrays)
    return jm, tm


@pytest.mark.parametrize("how", ["greedy", "temperature0"])
def test_generate_matches_jax(how):
    jm, tm = _gpt_pair()
    rng = np.random.default_rng(35)
    batch = rng.integers(0, 512, (3, 7)).astype(np.int32)
    ragged = [rng.integers(0, 512, (n,)).astype(np.int32)
              for n in (4, 11, 6)]
    kw = ({"greedy": True} if how == "greedy" else {"temperature": 0.0})
    for prompts in (batch, ragged):
        want = jm.generate(prompts, max_new_tokens=6, max_len=64, **kw)
        got = tm.generate(torch.from_numpy(prompts)
                          if isinstance(prompts, np.ndarray) else prompts,
                          max_new_tokens=6, max_len=64, device="cpu", **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == np.int32 \
                and g.ndim == 1
            np.testing.assert_array_equal(g, np.asarray(w))
