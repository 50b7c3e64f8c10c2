"""The GPT block's attention through the ring on the card (marked
``gpu``; JAX-free): GPT-2 345M's block width (hidden 1024, 16 heads of
64) at (1, 1024) bf16, on a one-rank ``sep`` group of an NCCL world of
one, against the same block with no ``sep`` group.  The ring of one
rank runs the flash forward in its f32-out mode and C2 / C3 in their
accumulating modes, once each, rounded once, so out and every gradient
equal the plain block's bit for bit, as ``chip_smoke.py``'s dist_nccl
reads the one-rank ring.

    python -m pytest tests/test_torch_cuda_seq_sharding.py -m gpu -q
"""
import os
import socket

import pytest
import torch

pytestmark = pytest.mark.gpu


def _block_run(block, x, dy):
    xs = x.detach().clone().requires_grad_(True)
    out = block(xs)
    grads = torch.autograd.grad(out, [xs] + list(block.parameters()), dy)
    return [out.detach()] + [g.detach() for g in grads]


def test_gpt_block_through_a_one_rank_ring_equals_the_plain_block():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import torch.distributed as dist

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig
    started = not dist.is_initialized()
    if started:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(PADDLE_MASTER="127.0.0.1:%d" % port,
                          PADDLE_TRAINER_ID="0", PADDLE_TRAINERS_NUM="1")
        D.init_parallel_env(backend="nccl")
    prev = dmesh.get_mesh()
    try:
        cfg = GPTConfig.gpt2_medium()
        cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
        torch.manual_seed(0)
        block = amp.decorate(GPTBlock(cfg), level="O2",
                             dtype="bfloat16").cuda()
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(1, 1024, 1024, generator=gen, device="cuda").to(
            torch.bfloat16)
        dy = torch.randn(1, 1024, 1024, generator=gen, device="cuda").to(
            torch.bfloat16)
        dmesh.set_mesh(None)
        plain = _block_run(block, x, dy)
        D.init_mesh({"dp": D.get_world_size(), "sep": 1})
        C.reset_counts()
        ring = _block_run(block, x, dy)
        issued = C.issued()
    finally:
        dmesh.set_mesh(prev)
        if started:
            dist.destroy_process_group()
    # the ring ran: its backward permutes the dK / dV accumulators once
    assert issued.get("ppermute", 0) == 1, issued
    for i, (a, b) in enumerate(zip(ring, plain)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
