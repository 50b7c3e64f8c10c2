"""paddle_tpu_torch stands alone: importing it loads neither JAX nor any
``paddle_tpu`` module, no file of the package imports either, and its
entry points refuse to fall back to the CPU when no card is present."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "paddle_tpu_torch"


def test_import_loads_no_jax_and_no_paddle_tpu():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch, paddle_tpu_torch.serving, "
        "paddle_tpu_torch.models, paddle_tpu_torch.amp, "
        "paddle_tpu_torch.convert, paddle_tpu_torch.kernels.norm_cuda, "
        "paddle_tpu_torch.kernels.flash_attention_cuda, "
        "paddle_tpu_torch.kernels.autotune, "
        "paddle_tpu_torch.kernels.ce_cuda, "
        "paddle_tpu_torch.jit, paddle_tpu_torch.optimizer, "
        "paddle_tpu_torch.regularizer, paddle_tpu_torch.nn.clip, "
        "paddle_tpu_torch.serving.pages, paddle_tpu_torch.nn.initializer, "
        "paddle_tpu_torch.observability, paddle_tpu_torch.robustness, "
        "paddle_tpu_torch.serving.frontend, "
        "paddle_tpu_torch.serving.loadgen, "
        "paddle_tpu_torch.serving.kv_tier, "
        "paddle_tpu_torch.serving.disagg, "
        "paddle_tpu_torch.serving.router, "
        "paddle_tpu_torch.distributed.store, "
        "paddle_tpu_torch.distributed.recompute, "
        "paddle_tpu_torch.distributed.collective, "
        "paddle_tpu_torch.distributed.mesh, "
        "paddle_tpu_torch.distributed.parallel_base, "
        "paddle_tpu_torch.distributed.mp_layers, "
        "paddle_tpu_torch.distributed.mp_overlap, "
        "paddle_tpu_torch.distributed.sharding, "
        "paddle_tpu_torch.distributed.pipeline, "
        "paddle_tpu_torch.distributed.fleet, "
        "paddle_tpu_torch.distributed.fleet.hybrid_optimizer, "
        "paddle_tpu_torch.distributed.ring_attention, "
        "paddle_tpu_torch.distributed.moe, "
        "paddle_tpu_torch.distributed.utils, "
        "paddle_tpu_torch.incubate.distributed.models.moe, "
        "paddle_tpu_torch.parallel, "
        "paddle_tpu_torch.nn.parallel, "
        "paddle_tpu_torch.robustness.retry, "
        "paddle_tpu_torch.observability.aggregate, "
        "paddle_tpu_torch.core.native, "
        "paddle_tpu_torch.io, paddle_tpu_torch.io.shm_queue, "
        "paddle_tpu_torch.incubate.checkpoint, "
        "paddle_tpu_torch.distributed.launch_main, "
        "paddle_tpu_torch.distributed.fleet.elastic\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m == 'paddle_tpu' "
        "or m.startswith('paddle_tpu.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_autotune_and_its_cli_load_no_jax_and_no_paddle_tpu(tmp_path):
    """Importing the autotuner, and its CLI's ``table`` on an empty cache
    (run as ``python -m``, and in-process with the modules it loads
    listed), loads neither JAX nor paddle_tpu."""
    env = dict(os.environ,
               PADDLE_TPU_AUTOTUNE_CACHE=str(tmp_path / "autotune.json"))
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "from paddle_tpu_torch.kernels import autotune\n"
        "autotune._cli_main(['table'])\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m == 'paddle_tpu' "
        "or m.startswith('paddle_tpu.'))\n"
        "print('BAD=' + ','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "autotune cache empty" in out.stdout
    assert out.stdout.strip().endswith("BAD=")
    cli = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.kernels.autotune", "table"],
        capture_output=True, text=True, cwd=str(PKG.parent), env=env,
        timeout=120)
    assert cli.returncode == 0, cli.stderr
    assert "autotune cache empty (%s)" % (tmp_path / "autotune.json") \
        in cli.stdout
    assert not (tmp_path / "autotune.json").exists()


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_imports_jax_or_paddle_tpu():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "paddle_tpu"), (f, mod)


def test_chip_smoke_and_the_rank_helpers_import_no_jax():
    """``chip_smoke.py``, the worker it launches
    (``tools/torch_launch_worker.py``) and the JAX-free helpers whose jobs
    the gloo ranks run (``tests/_torch_*.py``) import neither JAX nor
    ``paddle_tpu``."""
    here = pathlib.Path(__file__).resolve().parent
    files = [PKG.parent / "chip_smoke.py",
             PKG.parent / "tools" / "torch_launch_worker.py"] + [
        here / ("_torch_%s.py" % n)
        for n in ("dist", "front", "pipe", "sep", "seq", "launch")]
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "paddle_tpu"), (f, mod)


def test_engine_without_device_raises_on_a_cpu_only_machine():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import DecodeEngine, generate
    m = GPTForCausalLM(GPTConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(m, [[1, 2, 3]], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.generate([[1, 2, 3]], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(m, device="cuda")
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainStep(m, GPTPretrainingCriterion(),
                  AdamW(parameters=m.parameters()))
    # the model stayed where it was: nothing moved on the way to the error
    assert next(m.parameters()).device.type == "cpu"


def test_cache_create_without_device_raises_on_a_cpu_only_machine():
    """``SlottedKVCache.create`` runs on the card unless the caller asks
    for the CPU: without a card and without ``device="cpu"`` it raises,
    and with ``device="cpu"`` it builds zeroed CPU buffers."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from paddle_tpu_torch.serving import SlottedKVCache
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlottedKVCache.create(2, 1, 16, 2, 8)
    cache = SlottedKVCache.create(2, 1, 16, 2, 8, device="cpu")
    assert cache.k.device.type == cache.lengths.device.type == "cpu"
    assert cache.k.shape == (2, 1, 16, 2, 8)
    assert int(cache.lengths.abs().sum()) == 0
