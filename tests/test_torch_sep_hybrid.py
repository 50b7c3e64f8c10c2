"""ZeRO and tensor parallelism over sequence shards in the port: the
tiny GPT sequence-sharded over ``sep`` (each rank its rows, the ring in
every block) with ``TrainStep(zero_stage=1|2|3)`` over ``sdp`` on
{"sdp": 2, "sep": 2}, and with the Megatron layout over ``mp`` on
{"mp": 2, "sep": 2} (a rank's heads / mp heads of its S / n rows, the
ring over the ranks that share its ``mp`` coordinate), against the JAX
package's one-device ``TrainStep`` on the same weights and global batch,
on one four-rank gloo world: five steps' losses to 1e-5, and the
gradients the optimizer takes at the first step (ZeRO's slices and the
tensor-parallel shards made whole) against JAX's eager ones (rtol 1e-5,
atol 1e-7), under AdamW and under SGD (whose step is proportional to the
gradient, so a mean over 'sep' where a sum is due would show), with the
batch sharded over ``sdp`` (on its first dimension, or on both with
``sep``) or replicated, with recompute, per layer and scan-layers; and
ZeRO-3 under the Megatron
layout on {"sdp": 2, "mp": 2}.  What stays refused on a 'sep' mesh (the
pipeline, the serving engine) is
tests/test_torch_seq_sharding.py's ``test_what_a_sep_mesh_refuses``."""
import numpy as np
import pytest

from test_torch_seq_sharding import (GRAD_ATOL, GRAD_RTOL, LOSS_TOL, S,
                                     _jax_ref)

import _torch_dist


@pytest.fixture(scope="module")
def world():
    w = _torch_dist.World(4)
    yield w
    w.close()


SDP_SEP = {"sdp": 2, "sep": 2}
MP_SEP = {"mp": 2, "sep": 2}

RUNS = {
    # name: (axes, optimizer, in_shardings, zero_stage, cfg)
    "zero1_adamw": (SDP_SEP, "adamw", "sdp", 1, {}),
    "zero1_sgd_seq_spec": (SDP_SEP, "sgd", "sdp_sep", 1, {}),
    "zero2_sgd": (SDP_SEP, "sgd", "sdp", 2, {}),
    "zero2_adamw_replicated": (SDP_SEP, "adamw", None, 2, {}),
    "zero3_sgd": (SDP_SEP, "sgd", "sdp", 3, {}),
    "zero3_adamw_recompute": (SDP_SEP, "adamw", "sdp_sep", 3,
                              {"use_recompute": True}),
    "zero3_sgd_scan": (SDP_SEP, "sgd", "sdp", 3, {"scan_layers": True}),
    "mp_adamw": (MP_SEP, "adamw", None, None, {}),
    # stage 3 under the Megatron layout without 'sep': the row-parallel
    # weights are read by their block, outside their Linear
    "zero3_mp_sgd": ({"sdp": 2, "mp": 2}, "sgd", "sdp", 3, {}),
    "mp_sgd_recompute": (MP_SEP, "sgd", None, None,
                         {"use_recompute": True}),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sep_hybrid_tracks_jax(world, name):
    axes, opt, spec, stage, cfg = RUNS[name]
    weights, ids, jlosses, jgrads, _ = _jax_ref(
        opt, cfg.get("scan_layers", False), S)
    outs = world.run("_torch_seq:job_sep_hybrid", weights=weights, ids=ids,
                     steps=5, axes=axes, opt=opt, spec=spec,
                     zero_stage=stage, cfg=cfg)
    for losses, grads in outs:
        assert losses == outs[0][0]
        np.testing.assert_allclose(losses, jlosses, rtol=LOSS_TOL)
        assert set(grads) == set(jgrads)
        for n, g in jgrads.items():
            np.testing.assert_allclose(grads[n], g, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=n)
    assert jlosses[-1] < jlosses[0]
