"""``chip_smoke.py``'s parity phases rehearsed on the CPU at a narrow
width: ``card_vs_cpu`` over ``paged_script`` and ``slotted_script``, a
bf16 engine (AMP O2) in the card engine's place against the f32 engine.
The quantized engines pass quant_parity's checks; an engine that names
int8 but keeps unquantized pools (what the bar on logits alone cannot
tell from a quantized one) fails them.  The CPU runs the plain
LayerNorm, so the LayerNorm counter here counts the script's runs under
``use_pallas_norm``."""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch import amp
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import DecodeEngine
from paddle_tpu_torch.utils import flags


class _Norm:
    layer_norm_fwd_launches = 0


def _counted(script, norm, f32):
    """``script``, counting its runs of the bf16 engine under
    ``use_pallas_norm`` in place of kernel B's launches."""
    def run(torch_, eng, inputs=None):
        out = script(torch_, eng, inputs)
        if flags.fast_get("use_pallas_norm") and eng.model is not f32:
            norm.layer_norm_fwd_launches += 1
        return out
    return run


@pytest.fixture(scope="module")
def setup():
    # the scripts' prompts draw token ids below GPT-2's vocabulary
    cfg = GPTConfig(vocab_size=50304, max_position_embeddings=256,
                    hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    f32 = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    f32.eval()
    bf16 = amp.decorate(copy.deepcopy(f32), level="O2", dtype="bfloat16")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 50257, (128,)).astype(np.int32)
               for _ in range(4)]
    norm = _Norm()

    def script(paged):
        s = (chip_smoke.paged_script(prompts[0]) if paged
             else chip_smoke.slotted_script(prompts))
        return _counted(s, norm, f32)

    def engine(**kw):
        return DecodeEngine(bf16, num_slots=4, max_len=256, device="cpu",
                            **kw)

    def cpu_kw(paged):
        return dict(num_pages=16) if paged else dict(paged=False)

    def hold(eng, phase, exact=None):
        return chip_smoke.card_vs_cpu(torch, eng, f32, script(eng.paged),
                                      flags, norm, phase, cpu_kw(eng.paged),
                                      exact=exact)
    exact = {paged: hold(engine(paged=paged), "parity")
             for paged in (True, False)}
    return engine, hold, exact


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"), dict(kv_dtype="fp8"),
                                dict(kv_dtype="int8", paged=False)],
                         ids=["paged-int8", "paged-fp8", "slotted-int8"])
def test_quant_parity_holds_a_quantized_engine(setup, kw):
    engine, hold, exact = setup
    eng = engine(**kw)
    out = hold(eng, "quant_parity", exact[eng.paged])
    assert set(out["card"]) == {False, True}


def test_quant_parity_rejects_an_engine_that_keeps_bf16_pools(setup):
    """The unquantized engine posing as int8: its logits lie within the
    bar of the CPU int8 engine's, but quantization moved them by 0."""
    engine, hold, exact = setup
    eng = engine()
    eng._kv_code_dtype = torch.int8
    assert eng.cache.k.dtype == torch.bfloat16
    with pytest.raises(AssertionError, match="quantization moved the card's "
                                             "logits by 0,"):
        hold(eng, "quant_parity", exact[True])


class _CpuCounters:
    """chip_smoke's Counters on the CPU: no kernel launches, so every
    count is 0 (B's count on the card equals its wrapper's)."""

    def reset(self):
        pass

    def read(self):
        return {"layer_norm_fwd": 0, "flash_fwd_tc": 0, "flash_fwd": 0}

    def b_on_device(self):
        return 0


def test_serve_http_rehearsed_on_the_cpu(monkeypatch):
    """The serve_http phase end to end against CPU engines (paged and
    slotted, 2 slots so requests queue): its HTTP client and done-event
    parsing, parity with the in-process run, /healthz, the load harness
    at a CPU-sized mix, and the shed, disconnect and drain checks."""
    from paddle_tpu_torch.observability import Tracer, liveness
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = GPTConfig(vocab_size=50304, max_position_embeddings=256,
                    hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    model.eval()
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 50257, (64,))
    prompts = [np.concatenate([shared, rng.integers(0, 50257, (64,))])
               .astype(np.int32) for _ in range(8)]
    load = {"qps": 40.0, "n_requests": 8, "seed": 0,
            "mix": ((8, 64), (4, 8))}
    liveness.enable(start=False)
    try:
        for paged in (True, False):
            tracer = Tracer()
            eng = DecodeEngine(model, num_slots=2, max_len=256,
                               device="cpu", paged=paged, tracer=tracer)
            line = chip_smoke.serve_http(torch, eng, tracer, prompts,
                                         _CpuCounters(), flags, model,
                                         load=load)
            assert line["same_greedy_tokens"] and line["statuses"] == [200]
            assert line["goodput_tokens"] == 8 * 32
            assert line["load"]["completed"] == 8
            assert line["shed"]["status_429"] >= 1
            assert len(line["disconnect"]["cut_requests"]) == 1
            assert line["drain"]["late_status"] == 503
    finally:
        liveness.disable()
