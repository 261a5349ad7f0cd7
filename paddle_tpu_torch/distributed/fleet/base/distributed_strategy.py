"""DistributedStrategy (a copy of ``paddle_tpu/distributed/fleet/base/
distributed_strategy.py``).

Reference: python/paddle/distributed/fleet/base/distributed_strategy.py:105
wrapping distributed_strategy.proto:269 (nested feature configs with enable
bits: ShardingConfig:33, HybridConfig:51, AMPConfig:58, RecomputeConfig:27…).

One plain dataclass-style object with the same nested dict surface;
consumed by the train-step builders instead of meta-optimizer selection.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


_DEFAULTS: Dict[str, Any] = {
    "amp": False,
    "amp_configs": {"init_loss_scaling": 32768.0, "incr_every_n_steps": 1000,
                    "decr_every_n_nan_or_inf": 2, "incr_ratio": 2.0,
                    "decr_ratio": 0.5, "use_dynamic_loss_scaling": True,
                    "custom_white_list": [], "custom_black_list": [],
                    "use_pure_fp16": False, "use_bf16": True, "level": "O1"},
    "recompute": False,
    "recompute_configs": {"checkpoints": [], "enable_offload": False},
    "sharding": False,
    "sharding_configs": {"stage": 1, "sharding_degree": 1, "segment_broadcast_MB": 32,
                         "gradient_merge_acc_step": 1, "offload": False},
    "pipeline": False,
    "pipeline_configs": {"accumulate_steps": 1, "micro_batch_size": 1,
                         "schedule_mode": "1F1B"},
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1, "tensor_init_seed": -1},
    "hybrid_configs": {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                       "sharding_degree": 1, "sep_degree": 1,
                       # ≙ reference pp_configs (virtual pipeline = the
                       # interleaved 1F1B schedule; spmd_pipeline_interleaved)
                       "pp_configs": {"virtual_pipeline_degree": 1}},
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "lamb": False,
    "lamb_configs": {"lamb_weight_decay": 0.01, "exclude_from_weight_decay": []},
    "lars": False,
    "lars_configs": {"lars_coeff": 0.001, "lars_weight_decay": 0.0005},
    "localsgd": False,
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "dgc": False,
    "dgc_configs": {"rampup_begin_step": 0},
    "gradient_scale_configs": {"scale_strategy": "avg"},
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "nccl_comm_num": 1,
    "find_unused_parameters": False,
    "heter_ccl_mode": False,
    "without_graph_optimization": True,
    "asp": False,
    "a_sync": False,
    "a_sync_configs": {"k_steps": -1},
    "auto": False,
    "semi_auto": False,
    "auto_search": False,
}


class DistributedStrategy:
    def __init__(self):
        self.__dict__["_cfg"] = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, name):
        cfg = self.__dict__["_cfg"]
        if name in cfg:
            return cfg[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        cfg = self.__dict__["_cfg"]
        if name.endswith("_configs") and name in cfg and isinstance(value, dict):
            cfg[name].update(value)
        else:
            cfg[name] = value

    def to_dict(self):
        return copy.deepcopy(self._cfg)

    def __repr__(self):
        on = [k for k, v in self._cfg.items() if v is True]
        return f"DistributedStrategy(enabled={on})"
