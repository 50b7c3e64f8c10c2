"""chip_smoke.py's auto_engine and sep_hybrid_gloo rehearsed on the CPU
(JAX-free) at a narrow width (2 layers, 2 heads of 64), the flash route
through its plain versions, counted:

* auto_engine: the Engine's fit over three (8, 1024) batches bit for bit
  the port's ``TrainStep`` over them, evaluate and predict, the
  launches of each call;
* sep_hybrid_gloo: the one-process runs at a 256-row sequence, then
  ``sep_hybrid_rank`` on each rank of a four-rank gloo world
  ({"sdp": 2, "sep": 2} at ZeRO stage 2, {"mp": 2, "sep": 2}) and
  ``sep_hybrid_hold``, which must refuse a gradient halved on one rank
  (a mean over 'sep' where a sum is due), a loss one ulp past its bar
  and a rank that launched its ring's forwards once too few."""
import copy
import math

import numpy as np
import pytest
import torch

import _torch_dist
import _torch_hybrid
import chip_smoke
from paddle_tpu_torch.models.gpt import GPTForCausalLM


def test_auto_engine_rehearsed(monkeypatch):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.utils import flags
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    counters = _torch_dist.PlainCounters(monkeypatch)
    cfg = _torch_dist.tp2_spec()["cfg"]
    base = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    line = chip_smoke.auto_engine(torch, base, amp, counters, flags,
                                  device="cpu")
    assert line["losses"] == line["step_losses"]
    assert len(line["losses"]) == chip_smoke.AUTO_STEPS
    assert line["mesh"] == {"dp": 1}
    assert line["predict_shape"] == [8, 1024, cfg.vocab_size]
    n = cfg.num_hidden_layers * chip_smoke.AUTO_STEPS
    assert line["launches"]["fit"]["flash_fwd_tc"] == n
    assert line["launches"]["evaluate"]["flash_bwd_dq"] == 0


def test_sep_hybrid_gloo_rehearsed_on_a_gloo_world(monkeypatch, tmp_path):
    """The one-process references, the four ranks' runs and the hold:
    each run's losses and the first step's named gradients within the
    phase's bars, a rank at 'sep' coordinate r launching r + 1 flash
    forwards and C2 / C3 pairs a layer and step.  The hold refuses a
    gradient halved on one rank, a loss one ulp past its bar, and a rank
    one forward short."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.utils import flags
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    counters = _torch_dist.PlainCounters(monkeypatch)
    cfg = _torch_hybrid.hybrid_cfg()
    refs = chip_smoke.sep_hybrid_reference(
        torch, cfg, amp, counters, flags, str(tmp_path), device="cpu",
        s=_torch_hybrid.HYBRID_S)
    world = _torch_dist.World(4)
    try:
        outs = world.run("_torch_hybrid:job_sep_hybrid_rank", refs=refs)
    finally:
        world.close()
    spec = {"cfg": cfg, "s": _torch_hybrid.HYBRID_S,
            "steps": chip_smoke.SEP_STEPS, "refs": refs}
    line = chip_smoke.sep_hybrid_hold(outs, spec)
    for name in chip_smoke.SEP_HYBRID_RUNS:
        assert max(max(r.values()) for r in line[name]["grad_rel_l2"]) \
            < 1e-2
        assert line[name]["max_loss_diff"] < 1e-3
    run = "sdp2_sep2_zero2"
    bad = copy.deepcopy(outs)
    sums = bad[3]["runs"][run]["grad_sums"]
    gg, gr, rr = sums["gpt.h.0.mlp.fc2.weight"]
    sums["gpt.h.0.mlp.fc2.weight"] = [gg / 4, gr / 2, rr]
    assert math.isclose(chip_smoke.grad_rel_l2(
        sums["gpt.h.0.mlp.fc2.weight"]), 0.5, rel_tol=0.05)
    with pytest.raises(AssertionError, match="rank 3"):
        chip_smoke.sep_hybrid_hold(bad, spec)
    bad = copy.deepcopy(outs)
    edge = refs["mp2_sep2"][0][1] + chip_smoke.SEP_LOSS_TOL
    for o in bad:
        o["runs"]["mp2_sep2"]["losses"][1] = float(np.nextafter(edge,
                                                                np.inf))
    with pytest.raises(AssertionError, match="mp2_sep2: losses"):
        chip_smoke.sep_hybrid_hold(bad, spec)
    bad = copy.deepcopy(outs)
    bad[1]["runs"][run]["launches"]["flash_fwd_tc"] -= 1
    with pytest.raises(AssertionError, match="rank 1"):
        chip_smoke.sep_hybrid_hold(bad, spec)
