"""Alias package (port of ``paddle_tpu/parallel/__init__.py``): the
parallelism stack lives in paddle_tpu_torch.distributed (mesh,
collectives, mp_layers, pipeline, sharding, fleet).  This namespace
re-exports it under the build plan's `parallel/` name (every name of
its ``__all__``, the launcher module ``launch`` too)."""
from .. import distributed as _distributed
from ..distributed import collective, fleet, mesh, mp_layers, pipeline, sharding  # noqa: F401
from ..distributed.mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                                     RowParallelLinear, TensorParallel,
                                     VocabParallelEmbedding,
                                     get_rng_state_tracker,
                                     with_sharding_constraint)
from ..distributed.pipeline import (LayerDesc, PipelineLayer, PipelineParallel,
                                    SegmentLayers, SharedLayerDesc,
                                    spmd_pipeline)

globals().update({name: getattr(_distributed, name)
                  for name in _distributed.__all__})
