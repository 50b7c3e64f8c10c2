"""paddle_tpu_torch's plain attention (``sdpa_reference_raw``) against
``paddle_tpu``'s on the CPU: 4-D (B, S, H, D) input and input of another
rank, which the JAX version takes as (..., S, D) without swapping axes;
and the default scale, ``1 / sqrt(d)`` rounded to the input's dtype, bit
for bit in bf16 at head dims whose square root is not exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import \
    sdpa_reference_raw as jax_sdpa
from paddle_tpu_torch.nn.functional import attention as attn


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 16, 4, 64)])
def test_plain_attention_matches_jax_on_3d_and_4d_input(shape, causal):
    q, k, v = _inputs(shape, 0)
    want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), is_causal=causal))
    got = attn.sdpa_reference_raw(*(torch.from_numpy(a) for a in (q, k, v)),
                                  is_causal=causal)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", [32, 96])
def test_default_scale_is_rounded_to_the_input_dtype(d):
    """bf16 at head dims 32 and 96: the port's output equals JAX's bit
    for bit (the exact 1 / sqrt(d) parted from it by one bf16 step)."""
    q, k, v = _inputs((2, 16, 4, d), d)
    want = np.asarray(jax_sdpa(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)), is_causal=True))
    got = attn.sdpa_reference_raw(*(torch.from_numpy(a).bfloat16()
                                    for a in (q, k, v)), is_causal=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_default_scale_is_exact_where_the_root_is():
    """At head dims 16, 64 and 256 the rounded scale is the exact one, so
    the GPT configurations and the flash route's default (the exact
    ``1 / sqrt(d)``, as the JAX flash kernels take it) see no change."""
    for d in (16, 64, 256):
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            assert attn._default_scale(d, dt) == 1.0 / d ** 0.5
    assert attn._default_scale(96, torch.bfloat16) != 1.0 / 96 ** 0.5
