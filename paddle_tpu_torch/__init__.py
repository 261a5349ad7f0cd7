"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for one NVIDIA
H100 (Hopper, ``sm_90a``).

The JAX package ``paddle_tpu`` stays the reference; this package grows
beside it slice by slice, mirroring its module names so each counterpart is
easy to find.  It imports ``torch`` and never ``jax`` or anything of
``paddle_tpu``.  Every Pallas kernel on a ported path becomes a CUDA C++
kernel written for Hopper (``csrc/``), built with ``nvcc`` at first use and
bound through ``ctypes`` (``ops/_build.py``); beside each kernel lives its
plain PyTorch version, which runs for CPU tensors only.

Entry points (models, serving engines) run on ``cuda`` unless the caller
passes ``device="cpu"``; with no CUDA device they raise instead of falling
back to the CPU.

Ported so far — GPT ragged paged serving:

- ``ops.ragged_paged_attention``  (kernel: ``csrc/ragged_paged_attention.cu``)
- ``models._decode``, ``models.gpt``
- ``serving``, ``serving_paged`` (``RaggedPagedContinuousBatchingEngine``)
- ``jit.bucketing``, ``utils.stats`` (subsets)

and GPT training on one device:

- ``ops.attention`` (kernels: ``csrc/flash_attention.cu``), ``ops.loss``
- ``regularizer``, ``optimizer`` (functional SGD, Momentum, Adam, AdamW)
- ``distributed.spmd`` (the one-device train step)
- ``models.gpt`` ``make_gpt_train_step``

and BERT pretraining on one device, with the fused LayerNorm epilogue:

- ``core.flags`` (the flag registry: ``FLAGS_use_fused_ln``,
  ``FLAGS_use_fused_adamw``)
- ``ops.fused`` (kernels: ``csrc/fused.cu`` — the LN epilogue's forward
  and backward, the flat AdamW sweep; ``csrc/position_hash.cuh`` is the
  dropout hash shared with the flash kernels)
- ``models.bert`` (``BertModel``, ``make_bert_train_step``)

and bucketed GPT serving over a KV cache:

- ``ops.paged_attention`` (kernel: ``csrc/paged_attention.cu``, one query
  per slot over table-selected pool blocks; ``csrc/paged_common.cuh`` holds
  the helpers it shares with the ragged kernel)
- ``models._decode`` (``PagedKV``, ``write_cache``, ``cached_attention``,
  the prompt/token/chunk embeddings, ``generate``), ``models.gpt``
  (``prefill``, ``decode_step``)
- ``serving`` (the contiguous ``ContinuousBatchingEngine``:
  ``ticks_per_sync``, ``prefill_chunk``), ``serving_paged``
  (``PagedContinuousBatchingEngine``)

With it every Pallas kernel of ``paddle_tpu`` has a CUDA counterpart here.

Then, with no new kernel: the serving engines' prefix cache, in-pack
speculation and sampling planes; their programs as CUDA graphs
(``jit.programs``); and the rest of GPT generation with the tiered KV
page store:

- ``models._decode`` — ``generate()`` as a prefill program and a decode
  step program replayed with its clock on the device, ``generate_beam``,
  ``generate_speculative`` (with ``speculative_accept``),
  ``save_generate_program``/``load_generate_program``
- ``kv_store`` (``KVPage``, ``TieredKVStore``, ``PageMigration``,
  ``chain_hex``) and the paged engines' store seams in ``serving_paged``
  (demotion on eviction and ``flush_prefix``, restores at admission,
  ``export_prefix_pages``, ``kvio``)
- ``utils.stats`` (``snapshot``, ``prometheus_text``)

and the telemetry core, host-side only, wired into the four engines (a
``tracer=`` each), the tiered store and the GPT train step (``monitor=``):

- ``telemetry`` (``Tracer``, ``TraceContext``, ``RequestTraceIndex``,
  ``TrainMonitor``, ``instrument_train_step``, the JSONL and Chrome
  exports), ``telemetry_memory`` (``MemoryLedger``), ``telemetry_ledger``
  (``RunLedger``, ``FlightRecorder``), ``profiler``, ``utils.stats``
  (histograms, the process-wide registry)

and ERNIE-MoE with the rest of the optimizer surface, on the kernels
above (the flash kernels train it, the ragged and paged decode kernels
serve it):

- ``ops.moe`` (gating, the one-hot, index and capacity-free dispatches),
  ``models.ernie_moe`` (``ErnieMoeModel``, ``make_ernie_moe_train_step``;
  ``models.gpt.StackedDecoder`` holds what it shares with GPT)
- ``optimizer.lr`` (the LR schedulers), ``nn.clip`` (the gradient
  clips), ``optimizer`` (the eager ``step()``, ``state_dict``, Adamax,
  Adagrad, Adadelta, RMSProp, Lamb, Lars), ``distributed.spmd``
  (``donate=False``)

and the serving fleet, host-side only, over the engines above (the ragged
kernel runs on every gateway tick; a bucketed paged replica adds the
flash forward at admission and the paged decode kernel):

- ``telemetry_slo`` (``SLOMonitor``, ``Objective``, ``PercentileSketch``),
  ``faults`` (``FaultPlan``, ``FaultyEngine``), ``gateway``
  (``ServingGateway``: admission and shedding, prefix-affinity routing,
  disaggregated prefill/decode with page migration, circuit breakers,
  retries, hedging, brownout), ``autoscaler`` (``ElasticAutoscaler``),
  ``ops_server`` (``OpsServer``, ``compute_probe`` on the card),
  ``telemetry_fleet`` (``FleetCollector``, ``TelemetrySpool``) and
  ``simulation`` (``SimClock``, ``SimEngine``, ``TrafficSim``)

and data-parallel training on ``torch.distributed``, one process per rank
(the flash and fused LN kernels run in every rank's step):

- ``distributed`` (``env``, ``collective``, ``topology``, ``fleet``,
  ``grad_comm``, ``sharding_rules``, ``spmd``, ``zero``,
  ``update_sharding``) and the data, sharding, ZeRO, update-sharding and
  ``grad_comm`` arms of the GPT and BERT train-step builders

and crash-consistent training, host-side only, around the train steps
above (the flash kernels run in every supervised step):

- ``jit.functional`` (``make_train_step``, ``make_accum_train_step``,
  ``make_eval_step``, ``sync_state_to_layer``, ``fold_in_step_key``:
  threefry2x32's ``fold_in``), ``distributed.checkpoint`` (the
  reference's on-disk format; sharded saves by spec tree, loads onto
  another layout), ``train_resilience`` (``CheckpointManager``,
  ``PreemptionGuard``, ``ResumableIterator``, ``TrainSupervisor``),
  ``distributed.store`` (the TCP store over ``csrc/kv_store.cpp``, host
  C++ built with ``g++``), ``distributed.fleet.elastic``,
  ``distributed.launch`` and ``ckpt_fsck``

and vision training on one device, with no kernel of its own (cuDNN
convolutions and plain PyTorch pooling and BatchNorm, as XLA computed
them for the reference):

- ``nn.initializer``, ``nn.layer`` (``Layer`` over ``torch.nn.Module``,
  ``building``; ``Linear``, ``Flatten``, ``Identity``, ``ReLU``,
  ``Conv1D/2D/3D``, the ``BatchNorm`` family, max, average and adaptive
  average pooling, ``Sequential``, ``LayerList``), ``nn.functional``
  (``linear``, ``relu``, ``conv1d/2d/3d``, the poolings, ``batch_norm``,
  ``cross_entropy``), ``tensor.manipulation.flatten``
- ``vision.models`` (the ResNet family, ``LeNet``,
  ``params_from_numpy``); the functional steps now train the state's
  buffers (``distributed.spmd``'s one-device step)

and the rest of the vision zoo with dropout, again with no kernel (the
reference drew its masks through XLA's threefry, not a Pallas kernel):

- ``core.rng`` (threefry2x32 over int64 tensors, bit-equal to
  ``jax.random``; streams, ``rng_scope``), ``nn`` (the dropouts,
  ``ReLU6``, ``Swish``), ``tensor.manipulation`` (``concat``,
  ``reshape``, ``transpose``, at the top level too); the train steps
  draw their masks from the step key
- ``vision.models``: AlexNet, VGG, SqueezeNet, MobileNet V1/V2,
  GoogLeNet, InceptionV3, DenseNet, ShuffleNetV2
"""

import torch

from .tensor.manipulation import (  # noqa: F401
    concat, flatten, reshape, transpose)

# Submodules imported on first attribute access, as the reference's
# package does for its fleet modules.
_LAZY = ("serving", "telemetry", "telemetry_slo", "faults", "gateway",
         "autoscaler", "ops_server", "telemetry_fleet", "simulation",
         "train_resilience")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (explicitly or by default)
    and absent — never a silent fallback to the CPU.  A bare ``cuda``
    resolves to the current card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
