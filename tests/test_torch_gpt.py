"""paddle_tpu_torch GPT: the weight bridge, full-forward logits against
``paddle_tpu``'s GPTForCausalLM at the tiny config in f32, and the
slotted cache path (prefill + decode views) against the full forward and
against the JAX package's DecodeView/PrefillView path, at every
position.  Weights are numpy arrays from a seed, loaded into both."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.serving.engine import DecodeEngine as JaxEngine
from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import (load_paddle_tpu_state,
                                      state_dict_from_numpy)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import DecodeEngine

# f32 on both sides; matmuls sum in other orders (XLA vs ATen)
ATOL = 1e-4


def _numpy_weights(names_shapes, seed=0, std=0.2):
    """Seeded weights, wider than the 0.02 initializer so that greedy
    tokens vary from step to step."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in names_shapes:
        if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = std * rng.standard_normal(shape)
        out[name] = a.astype(np.float32)
    return out


def _pair(seed=0):
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.eval()
    arrays = _numpy_weights(
        [(k, tuple(v.shape)) for k, v in jm.state_dict().items()], seed)
    jm.set_state_dict(arrays)
    tm = GPTForCausalLM(GPTConfig.tiny())
    load_paddle_tpu_state(tm, arrays)
    tm.eval()
    return jm, tm, arrays


def _torch_full(tm, ids):
    with torch.no_grad():
        return tm(torch.as_tensor(np.asarray(ids, np.int32)[None])).numpy()[0]


def test_bridge_round_trips_every_name_and_shape():
    jm = JaxGPT(JaxGPTConfig.tiny())
    arrays = {k: v.numpy() for k, v in jm.state_dict().items()}
    assert len(arrays) == 28
    tm = GPTForCausalLM(GPTConfig.tiny())
    load_paddle_tpu_state(tm, arrays)
    sd = tm.state_dict()
    assert list(sd) == list(arrays)
    for k, a in arrays.items():
        assert tuple(sd[k].shape) == a.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), a, err_msg=k)
    assert sd["gpt.h.0.attn.qkv_proj.weight"].shape == (64, 192)
    t = state_dict_from_numpy({"w": np.ones((2, 3), np.float32)})["w"]
    assert t.dtype == torch.float32 and t.shape == (2, 3)


def test_bridge_rejects_mismatched_state():
    tm = GPTForCausalLM(GPTConfig.tiny())
    arrays = {k: v.numpy() for k, v in tm.state_dict().items()}
    with pytest.raises(KeyError):
        load_paddle_tpu_state(tm, dict(arrays, extra=np.zeros(1)))
    arrays["gpt.wte.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        load_paddle_tpu_state(tm, arrays)


def test_full_forward_logits_match_jax_every_position():
    jm, tm, _ = _pair()
    ids = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    want = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_slotted_prefill_decode_matches_full_forward_and_jax():
    jm, tm, _ = _pair(seed=2)
    je = JaxEngine(jm, num_slots=2, max_len=64, paged=False, seed=0)
    te = DecodeEngine(tm, num_slots=2, max_len=64, paged=False,
                      device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, (5,)), rng.integers(0, 512, (19,))]
    seqs = []
    for i, p in enumerate(prompts):
        jt, jl = je.prefill(i, p, temperature=0.0)
        tt, tl = te.prefill(i, p, temperature=0.0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(tl.numpy(), _torch_full(tm, p)[-1],
                                   atol=ATOL, rtol=0)
        assert tt == jt
        seqs.append(list(p) + [tt])
    for _ in range(6):
        toks = [s[-1] for s in seqs]
        args = (toks, [True, True], [0.0, 0.0], [0, 0], [1.0, 1.0])
        jn, jl = je.decode(*args)
        tn, tl = te.decode(*args)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        for b in range(2):
            np.testing.assert_allclose(tl[b].numpy(),
                                       _torch_full(tm, seqs[b])[-1],
                                       atol=ATOL, rtol=0)
            seqs[b].append(int(tn[b]))
        assert list(tn) == list(jn)
    assert list(te.slot_lengths()) == [len(s) - 1 for s in seqs]


def test_model_level_cache_decode_matches_full_forward():
    _jm, tm, _ = _pair(seed=3)
    ids = np.random.default_rng(3).integers(0, 512, (2, 8)).astype(np.int32)
    with torch.no_grad():
        full = tm(torch.as_tensor(ids)).numpy()
        cache = tm.gen_cache(2, max_len=32)
        outs = []
        for t in range(8):
            logit, cache = tm(torch.as_tensor(ids[:, t:t + 1]), cache=cache)
            outs.append(logit.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full,
                               atol=ATOL, rtol=0)
    assert cache.lengths.tolist() == [8, 8]


def test_inactive_slot_at_capacity_drops_its_append():
    """A frozen slot at max_len keeps computing: its write is dropped (the
    JAX scatter drops rows past max_len) and its length stays frozen."""
    _jm, tm, _ = _pair(seed=4)
    with torch.no_grad():
        cache = tm.gen_cache(2, max_len=8)
        cache.lengths[0] = 8
        k_before = cache.k[0].clone()
        from paddle_tpu_torch.serving import DecodeView
        view = DecodeView(cache, active=torch.tensor([False, True]))
        tm(torch.tensor([[1], [2]], dtype=torch.int32), cache=view)
        view.finalize()
    assert cache.lengths.tolist() == [8, 1]
    torch.testing.assert_close(cache.k[0], k_before, atol=0, rtol=0)


def test_multi_token_append_past_capacity_keeps_the_last_real_row():
    """An s > 1 append that runs past max_len writes its in-range rows and
    drops the rest; the dropped rows must not clobber the last real one."""
    from paddle_tpu_torch.serving import DecodeView, SlottedKVCache
    rng = np.random.default_rng(6)
    cache = SlottedKVCache.create(2, 1, 8, 2, 4, device="cpu")
    cache.lengths[0] = 6
    k_old = torch.as_tensor(rng.standard_normal((2, 1, 8, 2, 4)),
                            dtype=torch.float32)
    cache.k.copy_(k_old)
    q, k_new, v_new = (torch.as_tensor(rng.standard_normal((2, 4, 2, 4)),
                                       dtype=torch.float32)
                       for _ in range(3))
    DecodeView(cache).attend(q, k_new, v_new)
    torch.testing.assert_close(cache.k[0, 0, 6:], k_new[0, :2], atol=0,
                               rtol=0)
    torch.testing.assert_close(cache.v[0, 0, 6:], v_new[0, :2], atol=0,
                               rtol=0)
    torch.testing.assert_close(cache.k[0, 0, :6], k_old[0, 0, :6], atol=0,
                               rtol=0)
    torch.testing.assert_close(cache.k[1, 0, :4], k_new[1], atol=0, rtol=0)


def test_amp_o2_keeps_layer_norms_f32():
    tm = amp.decorate(GPTForCausalLM(GPTConfig.tiny()), level="O2",
                      dtype="bfloat16")
    for name, p in tm.named_parameters():
        want = (torch.float32 if ".ln" in name else torch.bfloat16)
        assert p.dtype == want, name
    ids = torch.randint(0, 512, (1, 16), dtype=torch.int32)
    with torch.no_grad():
        assert tm(ids).dtype == torch.bfloat16
