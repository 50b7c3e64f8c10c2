"""paddle_tpu_torch stands alone: importing it loads neither JAX nor any
``paddle_tpu`` module, no file of the package imports either, and its
entry points refuse to fall back to the CPU when no card is present."""
import ast
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
        "paddle_tpu_torch.kernels.ce_cuda, "
        "paddle_tpu_torch.jit, paddle_tpu_torch.optimizer, "
        "paddle_tpu_torch.regularizer, paddle_tpu_torch.nn.clip\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m == 'paddle_tpu' "
        "or m.startswith('paddle_tpu.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


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
