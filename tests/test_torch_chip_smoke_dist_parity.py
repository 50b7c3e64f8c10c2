"""``chip_smoke.py``'s distributed phases rehearsed on the CPU over gloo
worlds of two (``tests/_torch_dist.py``) at a narrow width: dist_nccl
and train_dp, tp2_gloo, zero_gloo (each with its own world), and
ring_gloo and moe_gloo (the ring and Ulysses at 128 rows a rank with the
flash route through its plain versions, counted; the MoE layer at ep = 1
and ep = 2), each held by the phase's own checks, and refused where a
rank's result is bent."""
import copy

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.models.gpt import GPTForCausalLM

from _torch_dist import PlainCounters as _PlainCounters


def test_dist_phases_rehearsed_on_a_gloo_world():
    """chip_smoke.py's dist_nccl and train_dp on a two-rank gloo CPU world
    (tests/_torch_dist.py's ``job_chip_dist``): every collective right at
    a world of two (point to point as a ring), the ops counted; train_dp
    over a one-rank dp axis issuing two all-reduces a step, its losses
    the default step's bit for bit, and so are those of its ZeRO stage-2
    run, which slices the masters over two sdp ranks."""
    import _torch_dist
    world = _torch_dist.World(2)
    try:
        out = world.run("job_chip_dist")
    finally:
        world.close()
    for dist_line, line, default in out:
        assert dist_line["backend"] == "gloo"
        assert dist_line["world_size"] == 2
        assert dist_line["max_abs_err"] <= 1e-6
        assert {"all_reduce", "all_gather", "reduce_scatter", "broadcast",
                "reduce", "scatter", "alltoall", "all_to_all_single",
                "all_gather_object", "send", "recv", "isend", "irecv",
                "barrier"} <= set(dist_line["collectives_issued"])
        assert line["collectives_issued"] == {"all_reduce": 6}
        assert line["dp_ranks"] == 1 and line["losses"] == default
        assert line["launches"]["flash_fwd_tc"] == 2 * 3
        zero = line["zero2"]
        assert zero["losses"] == default and zero["sliced_masters"] > 0
        assert zero["collectives_issued"]["reduce_scatter"] > 0


def test_tp2_gloo_rehearsed_on_a_gloo_world(monkeypatch):
    """chip_smoke.py's tp2_gloo logic on a two-rank gloo CPU world at a
    narrow width in f32: ``tp2_rank`` on each rank (the tp=2 engine's
    greedy tokens against tp=1's, B counted under ``use_pallas_norm``,
    three dp1 x mp2 train steps with the flash route counted), then
    ``tp2_hold``'s checks against the unsharded step's losses; a rank
    whose tokens part where tp=1's margin is wide is refused."""
    import _torch_dist
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    counters = _PlainCounters(monkeypatch)
    spec = _torch_dist.tp2_spec()
    base = GPTForCausalLM(spec["cfg"],
                          generator=torch.Generator().manual_seed(0))
    ids = chip_smoke.train_ids(torch, spec["cfg"].vocab_size, "cpu")
    default, _l, _ms = chip_smoke.run_steps(
        torch, chip_smoke.make_step(copy.deepcopy(base), device="cpu"),
        ids, counters, 3)
    world = _torch_dist.World(2)
    try:
        outs = world.run("job_tp2_rank", default_losses=default)
    finally:
        world.close()
    spec["default_losses"] = default
    forwards = chip_smoke.TP2_PROMPTS + chip_smoke.TP2_NEW_TOKENS
    line = chip_smoke.tp2_hold(outs, spec, forwards)
    assert line["tokens_equal_tp1"] and line["heads_per_rank"] == 1
    # the overlapped engines and train step ran their islands over gloo
    assert line["overlap_tokens_equal_monolithic"] == {"per_layer": True,
                                                       "scan": True}
    for name in ("per_layer", "scan"):
        assert line["overlap"][name]["ppermute_per_forward"] > 0
    assert line["overlap_train_loss_diff"] < 1e-4
    assert line["sharded_masters"] > 0
    assert line["max_loss_diff"] < 1e-4
    assert "uncaptured" in line["uncaptured"]
    bad = [dict(o) for o in outs]
    bad[0]["parted"] = [{"request": 0, "step": 3, "tokens": [1, 2],
                         "tp1_top2_margin": 1.0}]
    with pytest.raises(AssertionError, match="margin is wide"):
        chip_smoke.tp2_hold(bad, spec, forwards)


def test_zero_gloo_rehearsed_on_a_gloo_world(monkeypatch, tmp_path):
    """chip_smoke.py's zero_gloo logic on a two-rank gloo CPU world at a
    narrow width in f32: ``zero_rank`` on each rank (stages 1-3, two steps
    each, the batch sharded over sdp, the flash route counted; stages 2
    and 3 saved and restored), then ``zero_hold``'s checks against the
    unsharded step's losses (slots half a rank's, stage 2-3
    reduce-scattering, stage 3's masters half, its losses stage 2's bit
    for bit, its gathered bytes at once within the token table plus one
    block; each rank's file its share, the restored next loss bit for
    bit); a rank holding the full slots, a stage 3 one ulp off stage 2,
    a file holding the whole state and a restored loss one ulp off are
    refused.  The batch is (8, 128)."""
    import _torch_dist
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "train_ids", _torch_dist.short_ids)
    counters = _PlainCounters(monkeypatch)
    spec = dict(_torch_dist.tp2_spec(), steps=2)
    base = GPTForCausalLM(spec["cfg"],
                          generator=torch.Generator().manual_seed(0))
    ids = chip_smoke.train_ids(torch, spec["cfg"].vocab_size, "cpu")
    default, _l, _ms = chip_smoke.run_steps(
        torch, chip_smoke.make_step(copy.deepcopy(base), device="cpu"),
        ids, counters, 2)
    world = _torch_dist.World(2)
    try:
        outs = world.run("job_zero_rank", save_dir=str(tmp_path))
    finally:
        world.close()
    line = chip_smoke.zero_hold(outs, spec, default)
    for stage in (1, 2, 3):
        assert line["stages"][stage]["max_loss_diff"] < 1e-4
        assert line["stages"][stage]["sliced_masters"] > 0
    three = line["stages"][3]
    assert three["losses"] == line["stages"][2]["losses"]
    assert all(p > 0 for p in three["gathered_peak_bytes"])
    for stage in (2, 3):
        for save in line["stages"][stage]["save"]:
            share = save["file_bytes"] / save["whole_state_bytes"]
            assert share < (0.75 if stage == 2 else 0.6), share
    bad = [dict(o, stages=dict(o["stages"])) for o in outs]
    bad[0]["stages"][2] = dict(bad[0]["stages"][2],
                               slots_bytes=outs[0]["full_slots_bytes"])
    with pytest.raises(AssertionError, match="stage 2 slots"):
        chip_smoke.zero_hold(bad, spec, default)
    bad = copy.deepcopy(outs)
    for o in bad:
        o["stages"][3]["losses"][1] = float(np.nextafter(
            o["stages"][3]["losses"][1], np.inf))
    with pytest.raises(AssertionError, match="stage 3 losses"):
        chip_smoke.zero_hold(bad, spec, default)
    bad = copy.deepcopy(outs)
    save = bad[1]["stages"][3]["save"]
    save["file_bytes"] = save["whole_state_bytes"]
    with pytest.raises(AssertionError, match="rank 1 checkpoint"):
        chip_smoke.zero_hold(bad, spec, default)
    bad = copy.deepcopy(outs)
    save = bad[0]["stages"][2]["save"]
    save["restored_next_loss"] = float(np.nextafter(save["next_loss"],
                                                    -np.inf))
    with pytest.raises(AssertionError, match="rank 0 checkpoint"):
        chip_smoke.zero_hold(bad, spec, default)


@pytest.fixture(scope="module")
def pair():
    import _torch_dist
    w = _torch_dist.World(2)
    yield w
    w.close()


def test_ring_gloo_rehearsed_on_a_gloo_world(pair):
    """chip_smoke.py's ring_rank on each rank of {"sep": 2}, then
    ``ring_hold``: the ring and Ulysses within the flash rule of one flash
    call over the whole sequence, rank r's ring running r + 1 forward and
    backward blocks (the causal skip), Ulysses one, the permutes and
    all-to-alls counted; a rank whose ring launched once too often, or
    whose output left the rule, is refused."""
    import _torch_sep
    outs = pair.run("_torch_sep:job_ring_rank")
    spec = _torch_sep.RING_SPEC
    acc = chip_smoke.ring_accumulators(torch, spec, torch.device("cpu"))
    assert acc["ok"] and acc["shape"] == [1, 128, 2, 64]
    line = chip_smoke.ring_hold(outs, spec, acc)
    assert line["accumulators"]["causal"]["adds_exactly"]
    assert [o["launches"]["flash_fwd_tc"] for o in line["ring"]] == [1, 2]
    assert [o["launches"]["flash_bwd_dq"] for o in line["ulysses"]] == [1, 1]
    assert all(o["within_flash_rule"] for o in line["ring"] + line["ulysses"])
    bad = copy.deepcopy(outs)
    bad[0]["ring"]["launches"]["flash_fwd_tc"] = 2
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.ring_hold(bad, spec)
    bad = copy.deepcopy(outs)
    bad[1]["ulysses"]["within_flash_rule"] = False
    with pytest.raises(AssertionError, match="flash rule"):
        chip_smoke.ring_hold(bad, spec)
    with pytest.raises(AssertionError, match="accumulating"):
        chip_smoke.ring_hold(outs, spec, dict(acc, ok=False))


def test_moe_gloo_rehearsed_on_a_gloo_world(pair):
    """chip_smoke.py's moe_rank on each rank of {"ep": 2} (the card's runs
    on the CPU), then ``moe_hold``: ep = 2 against ep = 1 within 1e-5,
    four all-to-alls at ep = 2 and none at ep = 1; a rank that exchanged
    nothing is refused."""
    import _torch_sep
    outs = pair.run("_torch_sep:job_moe_rank")
    spec = _torch_sep.MOE_SPEC
    line = chip_smoke.moe_hold(outs, spec)
    assert max(line["ep2_vs_ep1_max"]) <= chip_smoke.MOE_EP_REL
    assert line["ep2_collectives_issued"] == [{"all_to_all_single": 4}] * 2
    assert line["ep1_vs_cpu_max"] == 0.0
    bad = copy.deepcopy(outs)
    bad[1]["ep2_collectives_issued"] = {}
    with pytest.raises(AssertionError, match="exchanges"):
        chip_smoke.moe_hold(bad, spec)


def test_moe_compare_holds_the_tokens_that_route_alike():
    """moe_gloo's comparison: a token routed differently is left out of
    the out and input-gradient rows, and the aux loss and parameter
    grads (sums over every token) are held only when no token routed
    differently; a near-tie token is counted."""
    probs = torch.tensor([[0.6, 0.3, 0.1], [0.5, 0.4, 0.1],
                          [0.4, 0.4, 0.2], [0.7, 0.2, 0.1]])
    route = torch.tensor([[0, 1], [1, 2], [2, 0], [0, 2]])
    out = torch.arange(8.0).reshape(1, 4, 2) + 1.0
    ref = {"probs": probs, "route": route, "out": out, "aux": 2.0,
           "grads": {"x": out * 2, "gate.gate.weight": torch.ones(3)}}
    got = copy.deepcopy(ref)
    got["route"][1] = torch.tensor([2, 1])
    got["out"][0, 1] = 100.0
    got["grads"]["x"][0, 1] = -100.0
    got["grads"]["gate.gate.weight"] += 1.0
    errs, near, differ, dmask, nmask = chip_smoke.moe_compare(
        torch, got, ref, lambda name: name)
    assert errs == {"out": 0.0, "x": 0.0} and (near, differ) == (1, 1)
    assert dmask.tolist() == [False, True, False, False]
    assert nmask.tolist() == [False, False, True, False]
    got = copy.deepcopy(ref)
    got["grads"]["gate.gate.weight"] *= 1.5
    errs, near, differ, _d, _n = chip_smoke.moe_compare(
        torch, got, ref, lambda name: name)
    assert differ == 0 and errs["aux"] == 0.0
    assert errs["gate.gate.weight"] == 0.5
