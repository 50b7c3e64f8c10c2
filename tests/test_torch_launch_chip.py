"""A CPU rehearsal of ``chip_smoke.py``'s ``native_runtime``,
``launch_elastic`` and ``launch_dp2_gloo`` phases: the same functions
and holds on the tiny GPT on the CPU (dropout 0.1, and 0 in the dp2
phase as on the card; the card runs 345M at 4 blocks), the launched workers importing the port only; then each
hold shown to fail when one resumed loss moves by one ulp (f32) or the
data cursor is off by one batch.  Launch counts are not held here (a
CPU tensor never reaches a kernel)."""
import copy
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

TINY = cs.launch_model_cfg(layers=2, vocab_size=512,
                           max_position_embeddings=128, hidden_size=64,
                           num_attention_heads=4, intermediate_size=128,
                           hidden_dropout_prob=0.1,
                           attention_dropout_prob=0.1)
SPEC = dict(device="cpu", model=TINY, batch=4, seq=32, amp=False,
            use_pallas_norm=False)


def _ulp_up(loss: str) -> str:
    x = np.float32(float(loss))
    return repr(float(np.nextafter(x, np.float32(np.inf))))


@pytest.fixture(scope="module")
def elastic():
    return cs.launch_elastic(torch, root=REPO, spec_kw=SPEC)


@pytest.fixture(scope="module")
def dp2():
    # dropout 0, as on the card: the ranks draw their masks per local
    # batch and one process per global batch, so with dropout the two
    # runs' losses differ by more than DP2_LOSS_TOL by design
    model = dict(TINY, hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    return cs.launch_dp2_gloo(torch, root=REPO,
                              spec_kw=dict(SPEC, model=model))


def test_native_runtime_phase():
    line = cs.native_runtime(torch)
    assert line["store_backends"] == ["native", "native"]
    assert line["segments_left"] == []


def test_launch_elastic_phase_holds(elastic):
    assert elastic["respawns"] == 1 and elastic["resumed_at"] == 4
    assert elastic["restored_cursor"] == {"epoch": 0, "batch": 4}
    # the CPU repeats bit for bit: the bar is 0
    assert elastic["repeat_bar"] == 0.0
    assert elastic["losses_resumed"] == {
        str(s): elastic["losses_uninterrupted"][str(s)] for s in range(4, 8)}
    # the save-cost figures: every step timed, one save call a step
    assert elastic["probe_save_call_ms"] > 0 and elastic["loop_step_ms"] > 0
    runs = elastic["runs"]
    assert sorted(runs["ref_a"]["save_call_ms"], key=int) == \
        [str(s) for s in range(8)]
    probe = runs["ref_b"]["save_probe"]
    assert len(probe["idle_step_ms"]) == len(probe["busy_step_ms"]) == \
        cs.LAUNCH_SAVE_PROBE


def _elastic_hold(runs):
    return cs.launch_elastic_hold(runs["ref_a"], runs["ref_b"],
                                  runs["first"], runs["resumed"],
                                  runs["backoff_log"], runs["crash_at"],
                                  runs["steps"])


@pytest.mark.parametrize("fault", ["loss_ulp", "cursor", "respawns",
                                   "route"])
def test_launch_elastic_hold_fails(elastic, fault):
    runs = copy.deepcopy(elastic["runs"])
    _elastic_hold(runs)
    if fault == "loss_ulp":
        runs["resumed"]["losses"]["6"] = _ulp_up(runs["resumed"]["losses"]
                                                 ["6"])
    elif fault == "cursor":
        runs["resumed"]["restored_cursor"]["batch"] += 1
    elif fault == "respawns":
        runs["backoff_log"] = runs["backoff_log"] * 2
    else:
        runs["first"]["route"] = "thread"
    with pytest.raises(AssertionError, match="launch_elastic"):
        _elastic_hold(runs)


def test_launch_elastic_hold_uses_the_repeat_bar(elastic):
    """When the two uninterrupted jobs differ, the bar is their largest
    difference: a resumed loss inside it passes, one past it fails."""
    runs = copy.deepcopy(elastic["runs"])
    a = float(runs["ref_a"]["losses"]["5"])
    runs["ref_b"]["losses"]["5"] = repr(a + 1e-3)
    runs["resumed"]["losses"]["5"] = repr(a + 5e-4)
    assert _elastic_hold(runs)["repeat_bar"] == pytest.approx(1e-3)
    runs["resumed"]["losses"]["5"] = repr(a + 2e-3)
    with pytest.raises(AssertionError, match="bar"):
        _elastic_hold(runs)


def test_launch_dp2_gloo_phase_holds(dp2):
    assert dp2["host_files"] == ["host-0.ckpt", "host-1.ckpt"]
    for got, first in zip(dp2["resumed_losses"], dp2["losses"]):
        assert got == {s: first[s] for s in ("2", "3")}
    assert [e["PADDLE_TRAINER_ID"] for e in dp2["env"]] == ["0", "1"]


def _dp2_hold(runs):
    cs.launch_dp2_hold(runs["single"], runs["job1"], runs["job2"],
                       runs["save_after"], runs["steps"], runs["master"],
                       runs["bar"], 0.0)


@pytest.mark.parametrize("fault", ["loss_ulp", "cursor", "env", "publish",
                                   "single", "diverged"])
def test_launch_dp2_hold_fails(dp2, fault):
    runs = copy.deepcopy(dp2["runs"])
    _dp2_hold(runs)
    if fault == "loss_ulp":
        runs["job2"][1]["losses"]["3"] = _ulp_up(runs["job2"][1]["losses"]
                                                 ["3"])
    elif fault == "cursor":
        runs["job2"][0]["restored_cursor"]["batch"] -= 1
    elif fault == "env":
        runs["job1"][1]["env"]["PADDLE_TRAINER_ID"] = "0"
    elif fault == "publish":
        runs["job1"][0]["host_files"] = ["host-0.ckpt"]
    elif fault == "diverged":
        runs["job1"][1]["params_sha256"] = "0" * 64
    else:
        runs["single"] = [x + 1.0 for x in runs["single"]]
    with pytest.raises(AssertionError, match="launch_dp2_gloo"):
        _dp2_hold(runs)
