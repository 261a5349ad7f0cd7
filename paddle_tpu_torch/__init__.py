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

and the eager surface a user's own model touches (the reference's
dygraph API over plain ``torch.Tensor``s; no methods are patched on):

- ``core.dtype`` (the dtype names, ``convert_dtype``, the default
  dtype), ``core.device`` (places, ``set_device``, device queries)
- ``tensor`` (``creation``, ``math``, ``logic``, ``manipulation``,
  ``search``, ``stat``, ``einsum``), at the top level too, with ``cast``,
  ``shape``, ``rank``, ``unbind`` and the ``reverse``/``bool`` aliases
- ``nn.functional`` (the activations, losses and common functionals;
  ``scaled_dot_product_attention`` over ``ops.attention``'s
  ``masked_attention``, the flash kernels for no mask or a key-padding
  mask), ``nn`` (the activation, loss and common layers,
  ``MultiHeadAttention`` and the ``Transformer*`` layers,
  ``params_from_numpy``)
- ``framework.io`` and the top level: ``save``/``load`` in the
  reference's pickle format (bf16 both ways), ``grad``, ``to_tensor``,
  ``seed``, ``create_parameter``, the places and the mode switches

and the random surface, the recurrent layers and beam search, plain
PyTorch as XLA computed them for the reference:

- ``core.rng`` (every ``jax.random`` law the reference draws: bits of 8
  to 64, uniform in four float dtypes, normal and truncated normal
  through XLA's ``erf_inv``, randint, permutation, gumbel, categorical,
  exponential, poisson, binomial), ``tensor.random``; the initializers,
  ``rrelu``, ``gumbel_softmax`` and the MoE gate's jitter draw from the
  streams, so ``seed(s)`` gives the reference's weights and draws
- ``nn`` (``SimpleRNN``/``LSTM``/``GRU``, their cells, ``RNN``/``BiRNN``,
  ``BeamSearchDecoder``, ``dynamic_decode``), ``nn.functional``
  (``class_center_sample``, ``gather_tree``)
"""

import builtins as _builtins

import numpy as np
import torch

from . import tensor as tensor_api  # noqa: F401
from .core.device import (  # noqa: F401
    device_count, get_device, is_compiled_with_cuda, is_compiled_with_tpu,
    set_device, synchronize)
from .core.dtype import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, float16, float32, float64,
    get_default_dtype, int8, int16, int32, int64, set_default_dtype, uint8)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.rng import get_rng_state, set_rng_state  # noqa: F401
from .tensor import *  # noqa: F401,F403
from .tensor import (  # noqa: F401
    cast, is_tensor, rank, set_printoptions, shape, unbind)

bool = bool_  # noqa: A001
reverse = flip  # noqa: F405 - the fluid-era alias
dtype = torch.dtype
Tensor = torch.Tensor
Parameter = torch.nn.Parameter
no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled

# Submodules imported on first attribute access, as the reference's
# package does for its fleet modules.
_LAZY = ("serving", "telemetry", "telemetry_slo", "faults", "gateway",
         "autoscaler", "ops_server", "telemetry_fleet", "simulation",
         "train_resilience", "nn", "optimizer", "distributed", "jit", "ops",
         "models", "vision", "framework", "profiler", "regularizer")
def __getattr__(name):
    import importlib
    if name in _LAZY:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name == "VarBase":                 # the legacy dygraph tensor name
        return torch.Tensor
    if name == "DataParallel":
        obj = importlib.import_module(".distributed", __name__).DataParallel
        globals()[name] = obj
        return obj
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


def seed(value):
    """``paddle.seed``: reseed ``core.rng``'s streams, which every draw of
    the port takes its key from (the initializers, ``tensor.random``, the
    dropouts)."""
    from .core import rng
    rng.seed(int(value))


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor of ``data`` (a tensor is copied) on ``place`` (a
    ``CPUPlace()``/``CUDAPlace(i)``, a device or its name; default the
    ``nn.building`` scope's, else ``cuda``).
    Python floats take the default dtype, an ndarray keeps its own;
    ``stop_gradient=False`` makes it require a gradient."""
    from .core.dtype import convert_dtype
    from .tensor.creation import _device
    dev = _device(place.torch_device() if hasattr(place, "torch_device")
                  else place)
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(dev, dt, copy=True)
    else:
        arr = np.array(data)
        if dt is None and not isinstance(data, np.ndarray) and \
                arr.dtype == np.float64:
            dt = get_default_dtype()      # Python floats: the default
        out = torch.as_tensor(arr, dtype=dt, device=dev)
    return out.requires_grad_(not stop_gradient)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, leaving every ``.grad`` untouched.  The graph is kept
    (``retain_graph`` None means True, as the reference's eager engine
    keeps it).  An input that gets no gradient raises unless
    ``allow_unused``, which gives None for it."""
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    single = not isinstance(inputs, (list, tuple))
    inputs = [inputs] if single else list(inputs)
    if grad_outputs is not None and not isinstance(grad_outputs,
                                                   (list, tuple)):
        grad_outputs = [grad_outputs]
    grads = torch.autograd.grad(
        outputs, inputs, grad_outputs,
        retain_graph=True if retain_graph is None else retain_graph,
        create_graph=create_graph, allow_unused=True)
    if not allow_unused and _builtins.any(g is None for g in grads):
        raise RuntimeError("one of the inputs received no gradient; "
                           "pass allow_unused=True to permit this")
    return list(grads)


def save(obj, path, protocol=4, **configs):
    """``paddle.save`` (``framework.io``)."""
    from .framework import io as _io
    return _io.save(obj, path, protocol=protocol, **configs)


def load(path, **configs):
    """``paddle.load`` (``framework.io``): ``device=`` places tensors."""
    from .framework import io as _io
    return _io.load(path, **configs)


def summary(net, input_size=None, dtypes=None, input=None):
    raise NotImplementedError("summary needs hapi, which waits for ROADMAP "
                              "A8b-2")


def flops(net, input_size, custom_ops=None, print_detail=False):
    raise NotImplementedError("flops needs hapi, which waits for ROADMAP "
                              "A8b-2")


def enable_static():
    raise NotImplementedError("static graphs wait for ROADMAP A8c")


def disable_static():
    """Eager mode is the only mode: nothing to do."""


def in_dynamic_mode():
    return True


def in_dygraph_mode():
    """Legacy alias of :func:`in_dynamic_mode`."""
    return in_dynamic_mode()


enable_dygraph = disable_static
disable_dygraph = enable_static


# ------------------------------------------------------------------ places
def CPUPlace():
    from .core.device import Place
    return Place("cpu")


def CUDAPlace(dev_id: int = 0):
    from .core.device import Place
    return Place(f"gpu:{dev_id}")


def CUDAPinnedPlace():
    """Page-locked host memory: a host place."""
    from .core.device import Place
    return Place("cpu")


def TPUPlace(dev_id: int = 0):
    raise RuntimeError("paddle_tpu_torch runs on CUDA devices; use "
                       "CUDAPlace() or CPUPlace()")


def NPUPlace(dev_id: int = 0):
    raise RuntimeError("paddle_tpu_torch is not compiled with NPU support")


def XPUPlace(dev_id: int = 0):
    raise RuntimeError("paddle_tpu_torch is not compiled with XPU support")


# ------------------------------------------------- legacy/top-level aliases
def get_cudnn_version():
    return torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None


def is_compiled_with_xpu():
    return False


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_npu():
    return False


def get_cuda_rng_state():
    """The state of every card's torch generator ([] without a card)."""
    return torch.cuda.get_rng_state_all() if torch.cuda.is_available() \
        else []


def set_cuda_rng_state(state_list):
    if state_list:
        torch.cuda.set_rng_state_all(state_list)


def disable_signal_handler():
    """The reference unhooks its C++ signal handlers; none are installed
    here."""


def monkey_patch_math_varbase():
    """The port patches no tensor methods (ROADMAP §C): a no-op."""


def monkey_patch_variable():
    """See monkey_patch_math_varbase."""


def tolist(x):
    return x.tolist() if hasattr(x, "tolist") else list(x)


def crop_tensor(x, shape=None, offsets=None, name=None):
    from .tensor import crop
    return crop(x, shape=shape, offsets=offsets)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter drawn as a layer's ``create_parameter`` draws it, on
    the ``nn.building`` scope's device (else ``cuda``)."""
    from .nn.layer.base import Layer
    return Layer().create_parameter(shape, attr, dtype, is_bias,
                                    default_initializer)
