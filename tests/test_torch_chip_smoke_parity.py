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


def test_serving_tier_phases_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's chunk_capture, serve_tier, serve_disagg and
    serve_fleet end to end against CPU engines at a narrow width: the
    serve traffic's shape (12 prompts of 64 shared and 64 own tokens, 32
    new each), the tier's three waves with a torn fetch and the cluster
    index, the disaggregated pair's device, host-staged and torn runs and
    its HTTP streams, and the fleet's affinity wave, replica kill,
    rejoin and cluster merge; every wave's tokens equal the colocated
    engine's (f32 on the CPU, so nothing parts)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cfg = GPTConfig(vocab_size=50304, max_position_embeddings=1024,
                    hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    model.eval()
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 50257, (64,))
    prompts = [np.concatenate([shared, rng.integers(0, 50257, (64,))])
               .astype(np.int32) for _ in range(12)]
    orng = np.random.default_rng(0)
    own = [orng.integers(0, 50257, (128,)).astype(np.int32)
           for _ in range(12)]
    counters = _CpuCounters()

    def run(engine, ps=prompts):
        results, _s, wall, _l, _i = chip_smoke.run_loop(
            torch, engine, ps, True, counters, flags, chip_smoke.LOOPS[0])
        return ([results[k].tokens for k in sorted(results)],
                chip_smoke.latency_fields(results, wall))

    paged = DecodeEngine(model, num_slots=8, max_len=1024, device="cpu")
    toks_paged, paged_line = run(paged)
    own_ref = [t.tolist() for t in run(paged, own)[0]]
    toks_tight, _ = run(DecodeEngine(model, num_slots=8, max_len=1024,
                                     num_pages=chip_smoke.TIGHT_PAGES,
                                     device="cpu"))
    _, slotted_line = run(DecodeEngine(model, num_slots=8, max_len=1024,
                                       paged=False, device="cpu"))
    line = chip_smoke.chunk_capture(torch, paged, prompts, own, counters,
                                    flags, paged_line, slotted_line)
    assert all(v["same_bits"]
               for v in line["bitwise_captured_vs_eager"].values())
    line = chip_smoke.serve_tier(torch, model, prompts, toks_tight,
                                 toks_paged, counters, flags, model,
                                 device="cpu")
    assert all(all(w["same_greedy_tokens"].values())
               for w in line["waves"])
    assert line["waves"][1]["host_hit_pages"] >= 2
    assert line["cluster_index"]["prompt_digests_covered"] > 0
    line = chip_smoke.serve_disagg(torch, model, prompts, toks_paged,
                                   counters, flags, model, device="cpu")
    assert all(r["same_greedy_tokens"] for r in line["runs"].values())
    assert line["runs"]["torn_handoff"]["requeued"] >= 1
    assert line["http"]["same_greedy_tokens"]
    line = chip_smoke.serve_fleet(torch, model, prompts, toks_paged, own,
                                  own_ref, counters, flags, model,
                                  device="cpu")
    assert line["undisturbed"]["same_greedy_tokens"]
    assert line["replica_1_killed"]["same_greedy_tokens"]
    assert line["failovers"] == 1 and line["requeues"] >= 1
    assert line["routed"]["second_wave"]["affinity"] == 4
    assert line["cluster"]["hosts"] == [0, 1]


# chip_smoke's Counters on the CPU (shared with the rehearsal on a gloo
# world, whose ranks import it from the JAX-free helper)
from _torch_dist import PlainCounters as _PlainCounters  # noqa: E402


def test_layout_train_phases_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's train_stack, train_scan and train_recompute at the
    train shape (8, 1024) on a narrow 2-layer model (two heads of 64),
    AMP O2 bf16 on the CPU, the flash route through its plain versions:
    the stacked templates, every loss equal to the default step's bit for
    bit (a default whose last loss moved by one ulp fails each phase),
    train_scan's profile, and the attention run twice a layer a step
    under recompute (once without)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    parts = {"optimizer_ms": 1.0, "write_back_ms": 1.0}
    monkeypatch.setattr(chip_smoke, "step_breakdown",
                        lambda *a, **k: dict(parts))
    monkeypatch.setattr(chip_smoke, "profile_steps",
                        lambda *a, **k: {"step_device_ms": 1.0})
    counters = _PlainCounters(monkeypatch)
    cfg = GPTConfig(vocab_size=512, max_position_embeddings=1024,
                    hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    base = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    ids = chip_smoke.train_ids(torch, cfg.vocab_size, "cpu")
    default, launches, _ms = chip_smoke.run_steps(
        torch, chip_smoke.make_step(
            chip_smoke.train_model(torch, base, amp, "cpu"), device="cpu"),
        ids, counters, 3)
    assert launches["flash_fwd_tc"] == launches["flash_bwd_dq"] == 2 * 3
    train_line = {"breakdown": parts, "peak_memory_gb": 1.0,
                  "profile": {"step_device_ms": 1.0}}
    line = chip_smoke.train_stack(torch, base, amp, counters, default,
                                  train_line, train_line, device="cpu")
    assert set(line["stacked_templates"].values()) == {2}
    assert line["losses"] == default
    lines = chip_smoke.train_scan(torch, base, amp, counters, default,
                                  device="cpu")
    assert [line["scan_mode"] for line in lines] == ["scan", "stack_vjp"]
    assert all(line["losses"] == default for line in lines)
    assert "profile" in lines[0]
    lines = chip_smoke.train_recompute(torch, base, amp, counters, default,
                                       train_line, device="cpu")
    for line in lines:
        assert line["launches"]["flash_fwd_tc"] == 2 * 2 * 3
        assert line["losses"] == default
    assert not base.config.use_recompute
    moved = default[:2] + [float(np.nextafter(np.float32(default[2]),
                                              np.float32(np.inf)))]
    for phase, args in (
            (chip_smoke.train_stack, (train_line, train_line)),
            (chip_smoke.train_scan, ()),
            (chip_smoke.train_recompute, (train_line,))):
        with pytest.raises(AssertionError, match="bit for bit"):
            phase(torch, base, amp, counters, moved, *args, device="cpu")


def test_serve_scan_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's serve_scan against CPU engines at a narrow width:
    the per-layer engines' runs of the serve traffic as references, then
    the scan-layers engines (paged in both loops, slotted, spec, int8)
    give their tokens; a reference with one token changed makes the
    phase fail naming the parting and the logit gap."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    profile = {"step_wall_ms": 1.0, "step_device_ms": 1.0,
               "device_busy_share": 1.0}
    profile["eager"] = dict(profile)
    monkeypatch.setattr(chip_smoke, "decode_profile",
                        lambda *a, **k: dict(profile))
    cfg = GPTConfig(vocab_size=50304, max_position_embeddings=1024,
                    hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=256,
                    hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    model.eval()
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 50257, (64,))
    prompts = [np.concatenate([shared, rng.integers(0, 50257, (64,))])
               .astype(np.int32) for _ in range(4)]
    counters = _PlainCounters(monkeypatch)
    refs = {}
    for name, kw, loop in chip_smoke.SCAN_ENGINES:
        if loop != chip_smoke.LOOPS[0]:
            continue
        eng = DecodeEngine(model, num_slots=8, max_len=1024, device="cpu",
                           **kw)
        fn = chip_smoke.serve_paged if eng.paged else chip_smoke.serve
        refs[name] = fn(torch, eng, prompts, True, counters, flags,
                        phase="ref")
    scan = chip_smoke.scan_copy(model)
    assert not scan.training and scan.config.scan_layers
    line = chip_smoke.serve_scan(torch, scan, model, prompts, refs, profile,
                                 counters, flags, device="cpu")
    assert [r["engine"] for r in line["runs"]] == [
        "paged", "paged", "slotted", "spec", "paged_int8"]
    assert all(r["same_greedy_tokens"] for r in line["runs"])
    assert all(r["layer_norm_fwd_launches"] > 0 for r in line["runs"])
    ref_line, ref_toks = refs["slotted"]
    bent = [t.copy() for t in ref_toks]
    bent[2][5] = (bent[2][5] + 1) % cfg.vocab_size
    refs["slotted"] = (ref_line, bent)
    with pytest.raises(AssertionError, match=r"'first_parting': \(2, 5\)"):
        chip_smoke.serve_scan(torch, scan, model, prompts, refs, profile,
                              counters, flags, device="cpu")


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


def test_zero_gloo_rehearsed_on_a_gloo_world(monkeypatch):
    """chip_smoke.py's zero_gloo logic on a two-rank gloo CPU world at a
    narrow width in f32: ``zero_rank`` on each rank (stages 1-3, two steps
    each, the batch sharded over sdp, the flash route counted), then
    ``zero_hold``'s checks against the unsharded step's losses (slots half
    a rank's, stage 2-3 reduce-scattering, stage 3's masters half); a
    rank holding the full slots is refused.  The batch is (8, 128)."""
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
        outs = world.run("job_zero_rank")
    finally:
        world.close()
    line = chip_smoke.zero_hold(outs, spec, default)
    for stage in (1, 2, 3):
        assert line["stages"][stage]["max_loss_diff"] < 1e-4
        assert line["stages"][stage]["sliced_masters"] > 0
    bad = [dict(o, stages=dict(o["stages"])) for o in outs]
    bad[0]["stages"][2] = dict(bad[0]["stages"][2],
                               slots_bytes=outs[0]["full_slots_bytes"])
    with pytest.raises(AssertionError, match="stage 2 slots"):
        chip_smoke.zero_hold(bad, spec, default)


def test_pipeline_and_tp_front_phases_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's serve_http_tp2, pp_single and pp2_gloo at tp2_spec's
    narrow width on the CPU (the flash route through its plain versions,
    counted; a two-rank gloo world for the two-rank phases), held by the
    phases' own checks; a follower that parts from rank 0 and a stage
    that permutes once too often are refused."""
    import _torch_dist
    import _torch_pipe
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "train_ids", _torch_dist.short_ids)
    counters = _PlainCounters(monkeypatch)
    cfg = _torch_dist.tp2_spec()["cfg"]
    base = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    single = chip_smoke.pp_single(torch, base, counters, flags,
                                  device="cpu")
    world = _torch_dist.World(2)
    try:
        serve = world.run("_torch_pipe:job_serve_tp2_rank")
        pp2 = world.run("_torch_pipe:job_pp2_rank")
    finally:
        world.close()
    # the follower's job returned after stop(), as its process would
    serve[1]["exitcode"] = 0
    spec = _torch_pipe.serve_tp2_spec()
    line = chip_smoke.serve_tp2_hold(serve, spec)
    assert line["tokens_equal_tp1"] and line["follower_same_results"]
    assert len(line["cancelled_rids"]) == 1
    assert line["requests"] == spec["requests"] * 2 + 2
    pline = chip_smoke.pp2_hold(pp2, {"cfg": cfg, "steps": 3, "device": "cpu"}, single)
    assert pline["max_loss_diff"] < 1e-4 and pline["ranks_same_params"]
    assert pline["peak_inflight"] == [3, 1]
    bad = [dict(o) for o in serve]
    bad[1]["finished"] = dict(bad[1]["finished"], **{"0": [[1], "length"]})
    with pytest.raises(AssertionError, match="follower's results"):
        chip_smoke.serve_tp2_hold(bad, spec)
    bad = [dict(o) for o in pp2]
    bad[1]["permutes_per_step"] += 2
    with pytest.raises(AssertionError, match="permutes a step"):
        chip_smoke.pp2_hold(bad, {"cfg": cfg, "steps": 3, "device": "cpu"}, single)
