"""chip_smoke.py's sep_train_gloo rehearsed on the CPU (JAX-free): the
one-rank train_long step at a narrow width (2 layers, 2 heads of 64, a
256-row sequence; the flash route through its plain versions, counted),
then sep_train_rank on each rank of {"sep": 2} over a gloo world of two
and ``sep_train_hold`` against the one-rank step, which must refuse a
gradient scaled by 1/2 on either rank (a mean over 'sep' where a sum is
due) and a loss one ulp past its bar."""
import copy
import math

import numpy as np
import pytest
import torch

import _torch_dist
import _torch_seq
import chip_smoke


def _long_reference(monkeypatch, path):
    """chip_smoke.py's train_long step at sep_spec's narrow width on the
    CPU, one rank (the flash route through its plain versions): its
    losses, and its first step's named gradients written to ``path``."""
    from paddle_tpu_torch import amp
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    counters = _torch_dist.PlainCounters(monkeypatch)
    cfg = _torch_seq.sep_cfg()
    step, ids = chip_smoke.long_step(torch, cfg, amp, "cpu", _torch_seq.SEP_S)
    seen = chip_smoke.record_grads(
        step, chip_smoke.sep_grad_names(cfg.num_hidden_layers))
    losses, launches, _ms = chip_smoke.run_steps(
        torch, step, ids, counters, chip_smoke.SEP_STEPS)
    assert launches["flash_fwd_tc"] == 2 * chip_smoke.SEP_STEPS
    torch.save({n: g.cpu() for n, g in seen.items()}, path)
    return losses


def test_sep_train_gloo_rehearsed_on_a_gloo_world(monkeypatch, tmp_path):
    """chip_smoke.py's sep_train_rank on each rank of {"sep": 2} at a
    narrow width, then ``sep_train_hold`` against the one-rank step: the
    losses, the first step's named gradients and their norm, rank r's
    ring r + 1 flash forwards and C2 / C3 pairs a layer and step.  The
    hold refuses a gradient scaled by 1/2 on either rank (what a mean
    over 'sep' would give) and a loss one ulp past its bar."""
    path = str(tmp_path / "long_grads.pt")
    losses = _long_reference(monkeypatch, path)
    pair = _torch_dist.World(2)
    try:
        outs = pair.run("_torch_seq:job_sep_train_rank", ref_grads=path,
                        ref_losses=losses)
    finally:
        pair.close()
    spec = _torch_seq.sep_spec(path, losses)
    line = chip_smoke.sep_train_hold(outs, spec)
    assert max(max(r.values()) for r in line["grad_rel_l2"]) < 1e-2
    assert [o["flash_fwd_tc"] for o in line["launches"]] == [4, 8]
    for rank in (0, 1):
        bad = copy.deepcopy(outs)
        sums = bad[rank]["grad_sums"]
        gg, gr, rr = sums["gpt.h.0.mlp.fc2.weight"]
        sums["gpt.h.0.mlp.fc2.weight"] = [gg / 4, gr / 2, rr]
        assert math.isclose(chip_smoke.grad_rel_l2(
            sums["gpt.h.0.mlp.fc2.weight"]), 0.5, rel_tol=0.05)
        with pytest.raises(AssertionError, match="rank %d" % rank):
            chip_smoke.sep_train_hold(bad, spec)
    bad = copy.deepcopy(outs)
    edge = losses[1] + chip_smoke.SEP_LOSS_TOL
    for o in bad:
        o["losses"][1] = float(np.nextafter(edge, np.inf))
    with pytest.raises(AssertionError, match="losses"):
        chip_smoke.sep_train_hold(bad, spec)
