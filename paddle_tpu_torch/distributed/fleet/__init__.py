"""``paddle_tpu_torch.distributed.fleet`` (counterpart of
``paddle_tpu/distributed/fleet``; reference: fleet/base/fleet_base.py —
Fleet:170 init, distributed_optimizer:829, distributed_model:882).

The Fleet singleton wires: DistributedStrategy → HybridCommunicateGroup
(one ``torch.distributed`` process group per axis) → the train-step
builders.  This is the collective-mode surface; the parameter-server
methods raise as the reference's do.
"""

from __future__ import annotations

from typing import Optional

from ..topology import (CommunicateTopology, HybridCommunicateGroup,  # noqa: F401
                        get_hybrid_communicate_group,
                        set_hybrid_communicate_group)
from .base.distributed_strategy import DistributedStrategy
from .base.role_maker import (PaddleCloudRoleMaker, Role, RoleMakerBase,  # noqa: F401
                              UserDefinedRoleMaker)
from . import meta_parallel  # noqa: F401
from .meta_parallel import (DataParallel, PipelineParallel, ShardingParallel,  # noqa: F401
                            TensorParallel)


class _RoleMaker(PaddleCloudRoleMaker):
    """Default role maker: the PaddleCloud env contract, with the
    ``torch.distributed`` rank and world as the fallback when no scheduler
    env is present."""

    def _generate_role(self):
        super()._generate_role()
        import os
        if self._role == Role.WORKER and \
                "PADDLE_TRAINER_ENDPOINTS" not in os.environ and \
                "PADDLE_TRAINERS_NUM" not in os.environ:
            from .. import env
            self._worker_endpoints = [f"process:{i}"
                                      for i in range(env.get_world_size())]
            self._current_id = env.get_rank()


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._role_maker = None
        self._user_defined_optimizer = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective: bool = True, strategy=None,
             log_level="INFO"):
        """Build the hybrid group over the running ``torch.distributed``
        world.  With no process group and a launcher world of more than
        one rank it calls ``init_parallel_env()`` (NCCL on the card); a
        one-rank world needs none."""
        from .. import env
        if not env.is_initialized() and env.get_world_size() > 1:
            env.init_parallel_env()
        self._strategy = strategy or DistributedStrategy()
        self._role_maker = role_maker or _RoleMaker(is_collective)
        hc = self._strategy.hybrid_configs
        self._hcg = HybridCommunicateGroup(
            dp_degree=hc.get("dp_degree", 1), mp_degree=hc.get("mp_degree", 1),
            pp_degree=hc.get("pp_degree", 1),
            sharding_degree=hc.get("sharding_degree", 1),
            sep_degree=hc.get("sep_degree", 1),
            virtual_pp_degree=hc.get("pp_configs", {})
                                .get("virtual_pipeline_degree", 1))
        set_hybrid_communicate_group(self._hcg)
        self._is_initialized = True
        return self

    # ------------------------------------------------------------- topology
    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        return self._hcg

    def worker_num(self):
        return self._role_maker._worker_num()

    def worker_index(self):
        return self._role_maker._worker_index()

    def is_first_worker(self):
        return self.worker_index() == 0

    def is_worker(self):
        return self._role_maker._is_worker()

    def is_server(self):
        return self._role_maker._is_server()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker._get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker._get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def server_num(self):
        return self._role_maker._server_num()

    def server_index(self):
        return self._role_maker._server_index()

    def rank(self):
        return self.worker_index()

    def nranks(self):
        return self.worker_num()

    def world_size(self):
        return self.worker_num()

    def local_rank(self):
        """Rank within this node (workers are laid out node-major)."""
        per_node = max(1, self.worker_num() // max(1, self.node_num()))
        return self.worker_index() % per_node

    def local_device_ids(self):
        import torch
        return list(range(torch.cuda.device_count()))

    def world_device_ids(self):
        return list(range(self.worker_num()))

    def node_num(self):
        """Nodes of the job: the world over ``LOCAL_WORLD_SIZE`` (one node
        when the launcher does not set it)."""
        import os
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
        return max(1, self.worker_num() // local) if local else 1

    def barrier_worker(self):
        from ..collective import barrier
        barrier()

    @property
    def util(self):
        if getattr(self, "_util", None) is None:
            from .utils import UtilBase
            self._util = UtilBase()
        return self._util

    # -------------------------------------------- PS lifecycle (non-goal)
    def init_worker(self):
        """PS worker bootstrap — collective-only build; nothing to start."""

    def init_server(self, *args, **kwargs):
        raise RuntimeError(
            "the parameter-server runtime is a declared non-goal of this "
            "build; use collective mode")

    run_server = init_server

    def stop_worker(self):
        pass

    def shrink(self, threshold=None):
        raise RuntimeError("PS sparse-table shrink is a parameter-server "
                           "feature; not available in the collective build")

    # -------------------------------- optimizer passthroughs (fleet_base)
    def _opt(self):
        if self._user_defined_optimizer is None:
            raise RuntimeError("call fleet.distributed_optimizer(...) first")
        return self._user_defined_optimizer

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._opt().minimize(loss)

    def step(self):
        return self._opt().step()

    def clear_grad(self):
        return self._opt().clear_grad()

    def get_lr(self):
        return self._opt().get_lr()

    def set_lr(self, value):
        return self._opt().set_lr(value)

    def state_dict(self):
        return self._opt().state_dict()

    def set_state_dict(self, state_dict):
        return self._opt().set_state_dict(state_dict)

    # ------------------------------------------------------------ model io
    def save_inference_model(self, *args, **kwargs):
        raise NotImplementedError("fleet.save_inference_model exports a "
                                  "static program: ROADMAP A8")

    def save_persistables(self, *args, **kwargs):
        raise NotImplementedError("fleet.save_persistables: the static "
                                  "program and io surface is ROADMAP A8")

    def load_model(self, *args, **kwargs):
        raise NotImplementedError("fleet.load_model: the static program "
                                  "and io surface is ROADMAP A8")

    # ------------------------------------------------------------ wrapping
    def distributed_model(self, model):
        """Reference fleet_base.py:882 — wrap by parallel mode."""
        mode = self._hcg.get_parallel_mode()
        from .meta_parallel.parallel_layers.pp_layers import PipelineLayer
        if isinstance(model, PipelineLayer) or mode == "PipelineParallel":
            return PipelineParallel(model, self._hcg, self._strategy)
        if mode == "TensorParallel":
            return TensorParallel(model, self._hcg, self._strategy)
        if mode == "ShardingParallel":
            return ShardingParallel(model, self._hcg, self._strategy)
        if mode == "DataParallel":
            return DataParallel(model, self._strategy)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """Reference fleet_base.py:829 — a HybridParallelOptimizer facade."""
        if strategy is not None:
            self._strategy = strategy
        self._user_defined_optimizer = optimizer
        from .meta_optimizers.hybrid_optimizer import HybridParallelOptimizer
        return HybridParallelOptimizer(optimizer, self._hcg, self._strategy)

    def distributed_scaler(self, scaler):
        return scaler

    # ------------------------------------------------------- train builders
    def distributed_train_step(self, layer, loss_fn, optimizer):
        """The hybrid step for (layer, loss, opt) (``spmd.
        make_spmd_train_step``) with the strategy's sharding stage and
        accumulation steps."""
        from ..spmd import make_spmd_train_step
        zero = 0
        if self._strategy.sharding:
            zero = int(self._strategy.sharding_configs.get("stage", 1))
        acc = int(self._strategy.pipeline_configs.get("accumulate_steps", 1)) \
            if self._strategy.pipeline else 1
        inner = getattr(optimizer, "_inner_opt", optimizer)
        return make_spmd_train_step(layer, loss_fn, inner, self._hcg,
                                    zero_stage=zero, accumulate_steps=acc)


fleet = Fleet()

# module-level API (paddle.distributed.fleet.init style)
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
distributed_scaler = fleet.distributed_scaler
distributed_train_step = fleet.distributed_train_step
get_hybrid_communicate_group = lambda: fleet._hcg or get_hybrid_communicate_group()  # noqa: E731
worker_num = fleet.worker_num
worker_index = fleet.worker_index
is_first_worker = fleet.is_first_worker
is_worker = fleet.is_worker
is_server = fleet.is_server
worker_endpoints = fleet.worker_endpoints
server_endpoints = fleet.server_endpoints
server_num = fleet.server_num
server_index = fleet.server_index
rank = fleet.rank
nranks = fleet.nranks
world_size = fleet.world_size
local_rank = fleet.local_rank
local_device_ids = fleet.local_device_ids
world_device_ids = fleet.world_device_ids
node_num = fleet.node_num
barrier_worker = fleet.barrier_worker
init_worker = fleet.init_worker
init_server = fleet.init_server
run_server = fleet.run_server
stop_worker = fleet.stop_worker
shrink = fleet.shrink
minimize = fleet.minimize
step = fleet.step
clear_grad = fleet.clear_grad
get_lr = fleet.get_lr
set_lr = fleet.set_lr
state_dict = fleet.state_dict
set_state_dict = fleet.set_state_dict
save_inference_model = fleet.save_inference_model
save_persistables = fleet.save_persistables
load_model = fleet.load_model

from .utils import UtilBase  # noqa: E402,F401
from . import metrics  # noqa: E402,F401
util = fleet.util
