"""paddle_tpu_torch's kernel autotuner (kernels/autotune.py) on the CPU:
the semantics of ``paddle_tpu/kernels/autotune.py`` mirrored from
tests/test_autotune.py on fake families (cache round-trip, precedence,
deterministic selection under fake timers, failures, the shared-memory
gate that takes the VMEM gate's place), the flash families' candidate
checks and CLI, and the port held against the JAX module itself: the
same pins, keys and cache files."""
import json
import os

import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.distributed import mp_overlap as jax_mpo
from paddle_tpu.kernels import autotune as jax_at
from paddle_tpu.kernels import decode_attention as jax_dat
from paddle_tpu.kernels import flash_attention_pallas as jax_fap
from paddle_tpu.utils import flags as jax_flags
from paddle_tpu_torch.kernels import autotune as at
from paddle_tpu_torch.kernels import decode_attention as dat
from paddle_tpu_torch.kernels import flash_attention_cuda as fac
from paddle_tpu_torch.utils import flags


def _reset(mod, monkeypatch):
    for name in ("_MEMO", "_MEMO_DEFAULT", "_RESOLVED"):
        monkeypatch.setattr(mod, name, {})
    monkeypatch.setattr(mod, "_CACHE", None)
    monkeypatch.setattr(mod, "_CACHE_LOADED_FROM", None)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test gets its own cache file, clean memos (both packages')
    and no pins."""
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE", raising=False)
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_PIN", raising=False)
    for reg in (flags._REGISTRY, jax_flags._REGISTRY):
        monkeypatch.setitem(reg, "autotune", False)
        monkeypatch.setitem(reg, "autotune_pin", "")
    _reset(at, monkeypatch)
    _reset(jax_at, monkeypatch)
    monkeypatch.setattr(at, "_FAMILIES", dict(at._FAMILIES))


KEY = {"n": 64, "f": 256, "dtype": "float32", "platform": "cpu"}
CANDS = [{"variant": "base", "config": {"rows": r}} for r in (8, 16, 32, 64)]


def _fake_family(runner=lambda cand, key: (lambda: None), smem=None,
                 name="fake"):
    return at.register_family(name, lambda key: [dict(c) for c in CANDS],
                              runner, smem_bytes=smem)


def _times(monkeypatch, seq):
    it = iter(seq)
    monkeypatch.setattr(at, "_time_callable", lambda fn, s: next(it))


def test_disabled_resolve_returns_registered_default():
    _fake_family()
    assert at.resolve("fake", KEY) == CANDS[0]
    # flash too: candidate [0] is kernel A's fixed tiles, and the f32
    # C1's 32-row tile
    fkey = fac.autotune_key(1, 256, 256, 2, 64, torch.float32, True, "cpu")
    assert at.resolve("flash_fwd", fkey) == {
        "variant": "base", "config": {"block_q": 64, "block_k": 64}}
    assert at.resolve("flash_bwd", fkey)["config"] == {"block_q": 32,
                                                       "block_k": 32}
    with pytest.raises(KeyError):
        at.resolve("ln", KEY)


def test_tune_selects_fastest_and_caches(monkeypatch):
    _fake_family()
    _times(monkeypatch, [5.0, 5.0, 1.0, 5.0])
    assert at.tune("fake", KEY) == CANDS[2]
    # persisted: a fresh process (memo cleared, cache reloaded) resolves
    # to the tuned pick without re-timing
    _reset(at, monkeypatch)
    monkeypatch.setattr(at, "_time_callable",
                        lambda fn, s: pytest.fail("re-timed a cached key"))
    assert at.resolve("fake", KEY) == CANDS[2]
    with open(at.cache_path()) as f:
        data = json.load(f)
    entry = data["families"]["fake"][at.key_str(KEY)]
    assert data["version"] == 1
    assert entry["variant"] == "base" and entry["config"] == {"rows": 32}
    assert entry["ms"] == 1.0 and entry["samples"] == 5
    assert len(entry["timings"]) == len(CANDS)


def test_tune_is_deterministic_under_equal_timers(monkeypatch):
    """Equal times: the first candidate (the default) wins; selection is
    strict improvement only."""
    _fake_family()
    monkeypatch.setattr(at, "_time_callable", lambda fn, s: 1.0)
    assert at.tune("fake", KEY) == CANDS[0]


def test_failed_candidates_are_skipped(monkeypatch):
    def runner(cand, key):
        if cand == CANDS[0]:
            raise RuntimeError("launch refused (simulated)")
        return lambda: None
    _fake_family(runner)
    _times(monkeypatch, [3.0, 1.0, 9.0])
    assert at.tune("fake", KEY) == CANDS[2]
    with open(at.cache_path()) as f:
        entry = json.load(f)["families"]["fake"][at.key_str(KEY)]
    assert entry["timings"][at._cand_sig(CANDS[0])] == \
        "failed: RuntimeError"


def test_nothing_timed_falls_back_to_the_first_candidate(monkeypatch):
    def runner(cand, key):
        raise RuntimeError("every launch refused (simulated)")
    _fake_family(runner)
    entry = at.tune("fake", KEY)
    assert entry == CANDS[0]
    with open(at.cache_path()) as f:
        assert json.load(f)["families"]["fake"][at.key_str(KEY)]["ms"] \
            is None


def test_smem_gate_rejects_before_launch_and_is_never_the_fallback(
        monkeypatch):
    """Candidates whose shared memory exceeds the limit are recorded as
    ``rejected: smem`` and never launched; when nothing times, the
    fallback is the first candidate that fits, and with none fitting
    tune() raises."""
    # the gate applies only where there is a limit (a card)
    assert at._smem_limit({"platform": "cpu"}) is None
    launched = []

    def runner(cand, key):
        launched.append(cand["config"]["rows"])
        raise RuntimeError("simulated")
    _fake_family(runner, smem=lambda c, key: 1000 * c["config"]["rows"])
    monkeypatch.setattr(at, "_smem_limit", lambda key: 20000)
    assert at.tune("fake", KEY) == CANDS[0]
    assert launched == [8, 16]
    with open(at.cache_path()) as f:
        timings = json.load(f)["families"]["fake"][at.key_str(KEY)][
            "timings"]
    assert timings[at._cand_sig(CANDS[2])] == \
        "rejected: smem (32000 > 20000)"
    assert timings[at._cand_sig(CANDS[3])].startswith("rejected: smem")
    # only the rejected ones left untimed: the first that fits is chosen
    monkeypatch.setattr(at, "_smem_limit", lambda key: 10000)
    assert at.tune("fake", KEY) == CANDS[0]
    monkeypatch.setattr(at, "_smem_limit", lambda key: 100)
    with pytest.raises(ValueError, match="shared memory"):
        at.tune("fake", KEY)


def test_pin_overrides_cache_and_tuning(monkeypatch):
    _fake_family()
    monkeypatch.setattr(at, "_time_callable", lambda fn, s: 1.0)
    at.tune("fake", KEY)
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_PIN", "fake=base:rows=64")
    assert at.resolve("fake", KEY)["config"]["rows"] == 64
    # FLAGS pin wins over the env pin
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin", "fake=base:rows=8")
    assert at.resolve("fake", KEY)["config"]["rows"] == 8
    # partial pins merge over the default config
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin", "fake=other")
    assert at.resolve("fake", KEY) == {"variant": "other",
                                       "config": {"rows": 8}}


PIN_STRINGS = [
    "flash_fwd=pipelined:block_q=128,block_k=64;flash_bwd=base",
    "flash_fwd=bf16chain+iotafree:block_q=256,block_k=128;ln=base:"
    "block_rows=16",
    " ce_lse = base : chunk = 1024 , x=1.5, on=true ;; bad ; ",
    "",
]


@pytest.mark.parametrize("raw", PIN_STRINGS)
def test_pins_parse_as_the_jax_module_does(raw, monkeypatch):
    """The pin grammar and _parse_scalar (ints, floats, bools, strings;
    several families): the same string gives the same dict in both
    packages."""
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_PIN", raw)
    assert at._pins() == jax_at._pins()
    if raw == PIN_STRINGS[1]:
        assert at._pins()["flash_fwd"] == {
            "variant": "bf16chain+iotafree",
            "config": {"block_q": 256, "block_k": 128}}
        assert at._pins()["ln"]["config"] == {"block_rows": 16}
    if raw == PIN_STRINGS[2]:
        assert at._pins()["ce_lse"]["config"] == {"chunk": 1024, "x": 1.5,
                                                  "on": True}


def test_keys_match_the_jax_module():
    for args in [(8, 1024, 1024, 16, 64, True), (1, 256, 256, 2, 128, False)]:
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32)):
            want = jax_fap.autotune_key(*args[:5], jdt, args[5])
            got = fac.autotune_key(*args[:5], tdt, args[5], "cpu")
            assert got == want
            assert at.key_str(got) == jax_at.key_str(want)
    key = {"z": 1, "a": "x", "m": True}
    assert at.key_str(key) == jax_at.key_str(key) == "a=x,m=True,z=1"


def test_cache_written_by_the_port_loads_in_the_jax_module(monkeypatch):
    """The cache file format is the JAX package's: a file the port's
    tune() wrote reads back through paddle_tpu's _load_cache with the
    same families, keys, variants and configs."""
    _fake_family()
    fkey = fac.autotune_key(1, 256, 256, 2, 64, torch.float32, True, "cpu")
    _times(monkeypatch, [3.0, 2.0, 1.0, 5.0] + [4.0, 1.0, 2.0, 3.0, 5.0]
           + [2.0, 1.0])
    at.tune("fake", KEY)
    at.tune("flash_fwd", fkey)
    at.tune("flash_bwd", fkey)
    got = jax_at._load_cache()
    with open(at.cache_path()) as f:
        mine = json.load(f)
    assert got == mine
    fams = got["families"]
    assert fams["fake"][at.key_str(KEY)]["config"] == {"rows": 32}
    assert fams["flash_fwd"][at.key_str(fkey)]["variant"] == "pipelined"
    assert fams["flash_fwd"][at.key_str(fkey)]["config"] == {
        "block_q": 64, "block_k": 32}
    assert fams["flash_bwd"][at.key_str(fkey)]["config"] == {
        "block_q": 64, "block_k": 64}
    # and the port resolves from it as the JAX module would
    _reset(at, monkeypatch)
    assert at.resolve("flash_fwd", fkey) == {
        "variant": "pipelined", "config": {"block_q": 64, "block_k": 32}}


def test_corrupt_cache_falls_back_to_default():
    _fake_family()
    path = at.cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("{not json")
    assert at.resolve("fake", KEY) == CANDS[0]


def test_invalid_cached_flash_config_is_sanitized(monkeypatch):
    """A stale or corrupt cache entry with tiles the kernels lack must not
    break the call: the flash wrapper falls back to candidate [0] and the
    answer is the plain attention's."""
    fkey = fac.autotune_key(1, 256, 256, 2, 64, torch.float32, True, "cpu")
    at._MEMO[("flash_fwd", at.key_str(fkey))] = {
        "variant": "pipelined", "config": {"block_q": 999, "block_k": 7,
                                           "hg": 3}}
    at._MEMO[("flash_bwd", at.key_str(fkey))] = {
        "variant": "base", "config": {"block_q": 48, "block_k": 48}}
    q = torch.randn(1, 256, 2, 64, generator=torch.Generator().manual_seed(0))
    assert fac._resolve_fwd(q, q, q, True) == ("base", 64, 64)
    assert fac._resolve_bwd(q, True, "flash_bwd") == 32
    out = fac.flash_attention_bshd(q, q, q, causal=True)
    want, _ = fac._flash_reference(q, q, q, True, 0.125)
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_flash_candidates_and_smem_hooks():
    """flash_fwd: f32 [0] kernel A, then A' at each instantiation that
    divides S; bf16 [0] the tensor-core forward at its tiles, then A'; the
    f32 C1: 32 then 64 rows at D 64 (32 alone at D = 256).  A''s
    shared memory matches its source's layout, and at f32 D = 256 only
    (64, 32) fits a block's 227 KB."""
    key = fac.autotune_key(8, 1024, 1024, 16, 64, torch.float32, True,
                           "cpu")
    cands = fac._fwd_candidates(key)
    assert cands[0] == {"variant": "base",
                        "config": {"block_q": 64, "block_k": 64}}
    assert [tuple(c["config"].values()) for c in cands[1:]] == \
        list(fac._PIPELINED_BLOCKS)
    assert all(c["variant"] == "pipelined" for c in cands[1:])
    short = dict(key, s=64, sk=64)
    assert len(fac._fwd_candidates(short)) == 3      # 128-row tiles drop
    bf16 = dict(key, dtype="bfloat16")
    assert [(c["variant"], tuple(c["config"].values()))
            for c in fac._fwd_candidates(bf16)] == \
        [("base", bs) for bs in fac._TC_FWD_BLOCKS[64]] + \
        [("pipelined", bs) for bs in fac._PIPELINED_BLOCKS]
    assert [c["config"]["block_q"] for c in fac._bwd_candidates(key)] == \
        [32, 64]
    assert [c["config"]["block_q"] for c in
            fac._bwd_candidates(dict(key, d=256))] == [32]
    # 16-bit A' (TMA ring): 1024 slack + q 64 x 64 x 2 + 4 slots of K and V
    # (4 x 2 x 64 x 64 x 2) + 256 bytes of barriers; f32 A' (3 x TF32): q
    # and three stages of K and V in rows of 68 floats
    assert fac.pipelined_smem_bytes(64, 64, 64, torch.bfloat16) == \
        1024 + 8192 + 65536 + 256
    assert fac.pipelined_smem_bytes(64, 64, 64, torch.float16) == 75008
    assert fac.pipelined_smem_bytes(64, 64, 64, torch.float32) == \
        (64 + 6 * 64) * 68 * 4
    f32 = dict(key, d=256, dtype="float32")
    fits = [c["config"] for c in fac._fwd_candidates(f32)[1:]
            if fac._fwd_smem(c, f32) <= 232448]
    assert fits == [{"block_q": 64, "block_k": 32}]
    assert fac._fwd_smem(cands[0], key) is None      # kernel A: no gate


def test_warm_and_cli_smoke(capsys, monkeypatch):
    """warm() on a real (small) flash key, timing the plain versions on
    the CPU, and the CLI's table / dump / warm / clear."""
    key = fac.autotune_key(1, 128, 128, 2, 64, torch.float32, True, "cpu")
    results = at.warm([("flash_fwd", key), ("flash_bwd", key)],
                      verbose=False)
    assert [r["variant"] in ("base", "pipelined") for r in results] == \
        [True, True]
    assert fac._RUNNER_DATA == {}            # operands freed after warm
    at._cli_main(["table"])
    out = capsys.readouterr().out
    assert "flash_fwd [" in out and "chosen:" in out and "pipelined:" in out
    at._cli_main(["dump"])
    assert json.loads(capsys.readouterr().out)["families"]["flash_bwd"]
    monkeypatch.setattr(at, "standard_keys", lambda: [("flash_fwd", key)])
    at._cli_main(["warm", "--family", "flash_fwd", "--quiet"])
    assert "flash_fwd [" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        at._cli_main(["warm", "--family", "ce_lse"])
    at._cli_main(["clear"])
    assert not os.path.isfile(at.cache_path())
    at._cli_main(["table"])
    assert "cache empty" in capsys.readouterr().out


def test_standard_keys_are_the_bench_shapes():
    """The four flash families at the training shape, the decode
    attention at the serving shape (slotted, and paged at one token a
    step, over the int8 pool, at the speculative verify's five and at
    tp=2: one rank's 8 heads) and the mp_overlap ring's tp=2 key: the JAX
    module's keys for them (the CPU: float32)."""
    pairs = at.standard_keys()
    assert [f for f, _ in pairs] == ["flash_fwd", "flash_bwd",
                                     "flash_bwd_dq", "flash_bwd_dkv",
                                     "decode_attn"] + \
        ["decode_attn_paged"] * 4 + ["mp_overlap"]
    want = jax_fap.autotune_key(8, 1024, 1024, 16, 64, jnp.float32, True)
    assert all(k == want for _, k in pairs[:4])
    assert pairs[4][1] == jax_dat.autotune_key(
        slots=8, t=1024, h=16, d=64, qlen=1, dtype=jnp.float32)
    paged = dict(slots=8, pages=128, page_size=64, max_pages=16, h=16, d=64,
                 dtype=jnp.float32)
    assert [k for _, k in pairs[5:9]] == [
        jax_dat.paged_autotune_key(qlen=1, **paged),
        jax_dat.paged_autotune_key(qlen=1, kv_dtype="int8", **paged),
        jax_dat.paged_autotune_key(qlen=5, **paged),
        jax_dat.paged_autotune_key(qlen=1, tp=2, **paged)]
    # the tp=2 row ring's chunk count at the projection shape
    assert pairs[9][1] == jax_mpo.autotune_key(
        kind="row", m=8, k=4096 // 2, n=1024, n_dev=2, dtype="float32")
    jax_pairs = jax_at.standard_keys()
    assert all((f, k) in jax_pairs for f, k in pairs[4:])


def test_paged_decode_family_matches_the_jax_module(monkeypatch):
    """decode_attn_paged: the JAX module's candidates for a key, the
    gather as candidate [0]; a pin of the chunked variant is what the
    paged views run; a pinned config that does not divide max_pages
    falls back to the gather; tune() times every candidate."""
    key = dat.paged_autotune_key(8, 128, 64, 16, 16, 64, 1, torch.float32,
                                 "cpu")
    jkey = jax_dat.paged_autotune_key(8, 128, 64, 16, 16, 64, 1,
                                      jnp.float32)
    assert key == jkey
    assert at.families()["decode_attn_paged"].candidates(key) == \
        jax_dat._paged_candidates(jkey)
    q = torch.zeros(8, 1, 16, 64)
    kp = torch.zeros(128, 64, 16, 64)
    table = torch.zeros(8, 16, dtype=torch.int64)
    assert dat.resolve_pages_per_block(q, kp, table) == 0
    for pin, want in (("paged_chunked:pages_per_block=4", 4),
                      ("paged_chunked:pages_per_block=3", 0),
                      ("paged_gather", 0)):
        monkeypatch.setitem(flags._REGISTRY, "autotune_pin",
                            "decode_attn_paged=" + pin)
        assert dat.resolve_pages_per_block(q, kp, table) == want
    monkeypatch.setitem(flags._REGISTRY, "autotune_pin", "")
    small = dat.paged_autotune_key(2, 8, 4, 4, 2, 8, 1, torch.float32,
                                   "cpu")
    _times(monkeypatch, [3.0, 1.0, 2.0])
    assert at.tune("decode_attn_paged", small) == {
        "variant": "paged_chunked", "config": {"pages_per_block": 1}}
    # the runner runs each candidate on the CPU
    for cand in at.families()["decode_attn_paged"].candidates(small):
        at.families()["decode_attn_paged"].runner(cand, small)()



def test_enabling_autotune_mid_process_still_tunes(monkeypatch):
    _fake_family()
    assert at.resolve("fake", KEY) == CANDS[0]
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "1")
    _times(monkeypatch, [9.0, 9.0, 1.0, 9.0])
    assert at.resolve("fake", KEY) == CANDS[2]
    assert at.enabled()
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE")
    monkeypatch.setitem(flags._REGISTRY, "autotune", True)
    assert at.enabled()


def test_multiprocess_jobs_never_tune_lazily(monkeypatch):
    """In a job of several processes resolve() must not time candidates
    (ranks could pick different variants); explicit tune() still does."""
    _fake_family()
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "1")
    monkeypatch.setattr(at, "_single_process", lambda: False)
    monkeypatch.setattr(at, "_time_callable",
                        lambda fn, s: pytest.fail("timed in a multi-process "
                                                  "job"))
    assert at.resolve("fake", KEY) == CANDS[0]
    monkeypatch.setattr(at, "_time_callable", lambda fn, s: 1.0)
    assert at.tune("fake", KEY) == CANDS[0]


def test_single_process_without_torch_distributed():
    assert at._single_process()


def test_report_includes_pins_and_counts_hits(monkeypatch):
    _fake_family()
    hits, misses = at.cache_hits, at.cache_misses
    at.resolve("fake", KEY)
    assert (at.cache_hits, at.cache_misses) == (hits, misses + 1)
    assert at.report()["fake"][at.key_str(KEY)]["config"] == {"rows": 8}
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_PIN", "fake=base:rows=16")
    at.resolve("fake", KEY)
    assert at.cache_hits == hits + 1
    assert at.report()["fake"][at.key_str(KEY)]["config"] == {"rows": 16}


def test_samples_and_cache_path_knobs(monkeypatch, tmp_path):
    assert at._samples() == 5
    monkeypatch.setitem(flags._REGISTRY, "autotune_samples", 3)
    assert at._samples() == 3
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_SAMPLES", "2")
    assert at._samples() == 2
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", "")
    assert at.cache_path() is None
    _fake_family()
    monkeypatch.setattr(at, "_time_callable", lambda fn, s: 1.0)
    at.tune("fake", KEY)            # persistence off: only the memo
    assert list(tmp_path.iterdir()) == []
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_CACHE")
    assert at.cache_path() == os.path.expanduser(
        "~/.cache/paddle_tpu_torch/autotune.json")
