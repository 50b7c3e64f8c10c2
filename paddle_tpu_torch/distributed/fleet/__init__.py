"""Fleet facade (port of ``paddle_tpu/distributed/fleet/__init__.py``;
reference surface: python/paddle/distributed/fleet/ — fleet.init at
fleet_base.py:206, distributed_model :932, distributed_optimizer :875,
DistributedStrategy).

``DistributedStrategy`` is a dataclass config tree (a dict assigned to one
of its config attributes is coerced, unknown keys dropped, as in the JAX
package); :meth:`_Fleet.init` lays the hybrid degrees over the
``torch.distributed`` world's ranks with :func:`..mesh.init_mesh` (a
world left over by the named degrees goes to ``dp``), and
``distributed_model`` wraps the layer for the active topology
(PipelineParallel / TensorParallel / ShardingParallel / DataParallel),
mirroring fleet_base.py:932.  ``fleet.elastic`` is the elastic
membership manager (:mod:`.elastic`) that goes with the launcher.
"""
from __future__ import annotations

import dataclasses

from .. import mesh as _mesh
from ..mesh import CommunicateTopology, HybridCommunicateGroup
from ..parallel_base import get_rank, get_world_size

__all__ = ["HybridConfig", "AMPConfig", "RecomputeConfig", "ShardingConfig",
           "PipelineConfig", "DistributedStrategy", "fleet", "init",
           "distributed_model", "distributed_optimizer",
           "get_hybrid_communicate_group", "worker_num", "worker_index",
           "is_first_worker", "barrier_worker"]


@dataclasses.dataclass
class HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1
    ep_degree: int = 1


@dataclasses.dataclass
class AMPConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O1"


@dataclasses.dataclass
class RecomputeConfig:
    enable: bool = False
    checkpoints: tuple = ()


@dataclasses.dataclass
class ShardingConfig:
    stage: int = 1
    offload: bool = False


@dataclasses.dataclass
class PipelineConfig:
    accumulate_steps: int = 1
    micro_batch_size: int = 1
    schedule_mode: str = "1F1B"


#: the config attributes a dict coerces into, and their dataclasses
_CONFIGS = {"hybrid_configs": HybridConfig,
            "sharding_configs": ShardingConfig,
            "pipeline_configs": PipelineConfig,
            "amp_configs": AMPConfig}


class DistributedStrategy:
    """reference parity: fleet/base/distributed_strategy.py (protobuf-backed
    in the reference; a typed dataclass tree here)."""

    def __init__(self):
        self.hybrid_configs = HybridConfig()
        self.amp = False
        self.amp_configs = AMPConfig()
        self.recompute = False
        self.recompute_configs = RecomputeConfig()
        self.sharding = False
        self.sharding_configs = ShardingConfig()
        self.pipeline = False
        self.pipeline_configs = PipelineConfig()
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.find_unused_parameters = False

    def __setattr__(self, k, v):
        cls = _CONFIGS.get(k)
        if cls is not None and isinstance(v, dict):
            v = cls(**{kk: vv for kk, vv in v.items()
                       if kk in cls.__dataclass_fields__})
        object.__setattr__(self, k, v)


class _Fleet:
    def __init__(self):
        self._strategy = None
        self._hcg = None
        self._topology = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None):
        """reference parity: fleet_base.py:206 — the hybrid topology and
        the global mesh over the world's ranks (a collective: every rank
        calls it, after ``init_parallel_env``)."""
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        n_dev = get_world_size()
        degrees = {"dp": hc.dp_degree, "pp": hc.pp_degree,
                   "sdp": hc.sharding_degree, "sep": hc.sep_degree,
                   "mp": hc.mp_degree, "ep": hc.ep_degree}
        specified = {k: v for k, v in degrees.items() if v > 1}
        total = 1
        for v in specified.values():
            total *= v
        if not specified:
            specified = {"dp": n_dev}
        elif hc.dp_degree <= 1 and total < n_dev:
            specified["dp"] = n_dev // total  # fill remaining onto dp
        _mesh.init_mesh(specified)
        topo = CommunicateTopology(
            ["data", "pipe", "sharding", "model"],
            [specified.get("dp", 1), specified.get("pp", 1),
             specified.get("sdp", 1), specified.get("mp", 1)])
        self._topology = topo
        self._hcg = HybridCommunicateGroup(topo, get_rank())
        self._is_initialized = True
        return self

    def get_hybrid_communicate_group(self):
        return self._hcg

    @property
    def worker_num(self):
        return get_world_size()

    def worker_index(self):
        return get_rank()

    def is_first_worker(self):
        return get_rank() == 0

    def barrier_worker(self):
        from ..collective import barrier
        barrier()

    def distributed_model(self, model):
        """reference parity: fleet_base.py:932 wrapper dispatch."""
        hc = self._strategy.hybrid_configs if self._strategy \
            else HybridConfig()
        if hc.pp_degree > 1:
            from ..pipeline import PipelineParallel
            return PipelineParallel(model, self._hcg, self._strategy)
        if hc.mp_degree > 1:
            from ..mp_layers import TensorParallel
            return TensorParallel(model, self._hcg, self._strategy)
        if hc.sharding_degree > 1:
            from ..sharding import ShardingParallel
            return ShardingParallel(model, self._hcg, self._strategy)
        from ...nn.parallel import DataParallel
        return DataParallel(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        from .hybrid_optimizer import HybridParallelOptimizer
        return HybridParallelOptimizer(optimizer, self._hcg, self._strategy)


fleet = _Fleet()

# module-level convenience mirroring `from paddle.distributed import fleet`
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker


def worker_num():
    return fleet.worker_num


def worker_index():
    return fleet.worker_index()


def __getattr__(name):
    # the elastic manager (a subpackage), imported on access
    if name == "elastic":
        import importlib
        return importlib.import_module(__name__ + ".elastic")
    raise AttributeError(name)
