"""``chip_smoke.py``'s fit_guard and serve_watch phases rehearsed on the
CPU at a narrow width (hidden 128, two heads of 64, (2, 64) batches): the
sentinel's replay after a NaN batch bit for bit, ``hapi.Model.fit``
under DivergenceMonitor against a bare step, the ledger, the flight dump,
the profiler's export and the cost report's flops against the closed
form; then the paged engine under ``PADDLE_TPU_STRICT_COMPILE=1`` with
stand-in captures (``tests/_torch_capture.py``), a forced capture
refused and the KV-pool bytes.  The card-only checks (launches, device
memory, kernel names, ``mfu``) are the card's (``test_torch_cuda_guard.py``).
This file imports no JAX."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from _torch_capture import stand_in_capture
from _torch_threads import one_thread  # noqa: F401  (autouse)
from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import ce_cuda, norm_cuda
from paddle_tpu_torch.kernels import flash_attention_cuda as fac
from paddle_tpu_torch.kernels import autotune as at
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.utils import flags


def _base():
    cfg = GPTConfig(vocab_size=512, max_position_embeddings=128,
                    hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    return GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))


@pytest.fixture
def lines(monkeypatch):
    out = []
    monkeypatch.setattr(cs, "emit", out.append)
    return out


def test_fit_guard_rehearsed(lines):
    base = _base()
    line = cs.fit_guard(torch, base, amp, cs.Counters(fac, norm_cuda,
                                                      ce_cuda), flags,
                        device="cpu", shape=(2, 64))
    assert lines == [line]
    assert line["replay"]["rewinds"] == [[cs.GUARD_NAN_AT,
                                          cs.GUARD_NAN_AT - 2]]
    masters = sum(p.numel() for p in base.parameters()) * 12
    assert masters <= line["replay"]["snapshot_host_bytes"] < masters + 4096
    fit = line["fit"]
    assert fit["rewinds"] == 1 and len(fit["losses"]) == cs.FIT_BATCHES
    assert np.isnan(fit["losses"][cs.FIT_NAN_AT])
    assert line["ledger"]["samples"] == cs.FIT_BATCHES
    assert line["cost"]["flops"] == cs.step_flops(base.config, 2, 64)
    assert line["cost"]["mfu"] is None        # no device time on the CPU
    assert not flags.fast_get("use_pallas_norm")


def test_fit_guard_refuses_a_replay_without_the_generators(lines,
                                                           monkeypatch):
    from paddle_tpu_torch.robustness import sentinel as sn
    monkeypatch.setattr(sn, "_generators", lambda train_step: [])
    with pytest.raises(AssertionError, match="part from the clean run"):
        cs.fit_guard(torch, _base(), amp, cs.Counters(fac, norm_cuda,
                                                      ce_cuda), flags,
                     device="cpu", shape=(2, 64))
    assert lines and "fit" not in lines[0]


def test_serve_watch_rehearsed(lines, monkeypatch):
    monkeypatch.setattr(engine_mod, "capture", stand_in_capture)
    init = engine_mod.DecodeEngine.__init__

    def capturing(self, *a, **k):
        init(self, *a, **k)
        self._capture = True
    monkeypatch.setattr(engine_mod.DecodeEngine, "__init__", capturing)
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", "")
    at.register_family("rehearsal", lambda key: [
        {"variant": "base", "config": {}}], lambda cand, key: (lambda: None))
    at.tune("rehearsal", {"n": 1}, persist=False)
    at.resolve("rehearsal", {"n": 1})
    at.resolve("rehearsal", {"n": 2})
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, (40,)).astype(np.int32)
               for _ in range(8)]
    line = cs.serve_watch(torch, _base(), amp, prompts, flags,
                          device="cpu", max_len=64)
    assert line["graph_stats"] == {"decode": 1, "spec": 0, "chunk": 1}
    assert line["finished"] == 8 and "serving.decode" in \
        line["forced_capture"]
    kv = line["kv_pool_bytes"]
    assert kv["ledger"] == kv["pool_tensors"] >= kv["engine"] > 0
