"""Functional train steps over an ``nn.Module`` (counterpart of the
training half of ``paddle_tpu/jit/functional.py``).

The reference functionalizes a Layer and jits one program a step; here a
step is the port's one-device step (``distributed.spmd._make_local_step``)
over the module's own parameters, in the reference's shape:
``step(state, key, lr, inputs, labels) -> (state, (loss, out))`` with
``state = {"params", "opt": {"step", "slots"}, "buffers"}`` (plus
``scaler``, ``acc``/``acc_count`` and ``comm_e`` where the reference adds
them), the tree ``train_resilience.TrainSupervisor`` checkpoints.

A key is its raw ``uint32[2]`` key data (numpy): torch has no typed keys.
:func:`fold_in_step_key` is threefry2x32's ``fold_in``, bit for bit
``jax.random.fold_in``, so a run resumed in either package derives the
same step keys.  Each step runs its forward under ``core.rng.rng_scope``
of its key, as the reference's ``functionalize`` does: the n-th dropout
draw of a step is ``fold_in(key, n)``, so the same key gives the
reference's masks.

``warm_train_step`` (the AOT seam) and a ``GradScaler`` object wait for
ROADMAP A8; ``scaler_cfg`` is read as far as the reference's
``_make_scaler`` reads it (``jit/functional.py:111``).
"""

from __future__ import annotations

import contextlib

import torch

from ..core import rng


def fold_in_step_key(base_key, step: int):
    """THE per-step RNG derivation: ``key_t = fold_in(base_key, t)``
    (reference ``jit/functional.py:322``).

    The step key is a pure function of (base key, step index), so a loop
    resumed at step ``t`` from a checkpoint (which stores only the base
    key and the step counter) regenerates the same key for every later
    step.  ``base_key`` is ``uint32[2]`` key data (numpy, a tensor or a
    list); the result is the ``uint32[2]`` key data of
    ``jax.random.fold_in(base_key, step)``: threefry2x32 of the key over
    the block ``(0, step)``."""
    return rng.fold_in(base_key, step)


def _scaler_knobs(scaler_cfg):
    """The dynamic loss-scale knobs of ``scaler_cfg`` with the reference's
    defaults (``_make_scaler``), or None."""
    if not scaler_cfg:
        return None
    return {"init_loss_scaling": float(scaler_cfg.get("init_loss_scaling",
                                                      2.0 ** 15)),
            "incr_ratio": float(scaler_cfg.get("incr_ratio", 2.0)),
            "decr_ratio": float(scaler_cfg.get("decr_ratio", 0.5)),
            "incr_every_n_steps": int(scaler_cfg.get("incr_every_n_steps",
                                                     1000)),
            "decr_every_n_nan_or_inf": int(scaler_cfg.get(
                "decr_every_n_nan_or_inf", 1))}


def _make_loss_of(layer, loss_fn, trace_ctx, out_box):
    """``loss_of(params, inputs, labels)``: the layer in training mode on
    ``inputs``, ``loss_fn`` of its (first) output and ``labels``; the
    output lands in ``out_box`` (reference ``_make_loss_of``)."""
    def loss_of(params, inputs, labels):
        was = layer.training
        layer.train()
        try:
            with (trace_ctx() if trace_ctx is not None
                  else contextlib.nullcontext()):
                out = layer(*inputs)
                main = out[0] if isinstance(out, (list, tuple)) else out
                out_box[:] = [main]
                return loss_fn(main, *labels)
        finally:
            layer.train(was)
    return loss_of


def _build(layer, loss_fn, optimizer, donate, trace_ctx, grad_comm,
           accum_steps=1, scaler_cfg=None):
    from ..distributed.grad_comm import resolve_policy
    from ..distributed.spmd import _make_local_step

    policy = resolve_policy(grad_comm)
    params0 = dict(layer.named_parameters())
    out_box = []
    inner, state0 = _make_local_step(
        _make_loss_of(layer, loss_fn, trace_ctx, out_box), params0,
        optimizer, layer, donate, policy, accum_steps=accum_steps,
        scaler=_scaler_knobs(scaler_cfg))
    state0["buffers"] = dict(layer.named_buffers())

    def step(state, key, lr, inputs, labels):
        with rng.rng_scope(key):
            state, loss = inner(state, lr, list(inputs), list(labels))
        return state, (loss, out_box[0].detach())

    return step, state0, params0, policy


def make_train_step(layer, loss_fn, optimizer, donate: bool = True,
                    trace_ctx=None, scaler_cfg=None, monitor=None,
                    grad_comm=None):
    """The train step over ``layer`` (reference ``jit/functional.py:161``):
    returns ``(step, state0)`` with ``step(state, key, lr, inputs,
    labels) -> (state, (loss, out))``, ``loss = loss_fn(layer(*inputs),
    *labels)``.

    With ``donate`` (the default) ``state["params"]`` are the layer's own
    parameters and the step updates them and the slots in place;
    ``donate=False`` leaves the given state untouched and returns a fresh
    one.  ``trace_ctx``: a context factory entered around each forward
    (e.g. an autocast).  ``scaler_cfg``: the knobs of an in-step dynamic
    loss scale (``state["scaler"]``: scale, good, bad); a step with a
    non-finite gradient keeps the old state.  ``grad_comm``: the policy in
    local mode (a stateful one adds ``comm_e``).  ``monitor`` wraps the
    step in ``telemetry.instrument_train_step``."""
    from ..distributed.grad_comm import comm_info
    from ..telemetry import instrument_train_step

    step, state0, params0, policy = _build(
        layer, loss_fn, optimizer, donate, trace_ctx, grad_comm,
        scaler_cfg=scaler_cfg)
    return instrument_train_step(step, monitor, "train_step",
                                 comm=comm_info(params0, policy)), state0


def make_accum_train_step(layer, loss_fn, optimizer, accum_steps: int,
                          donate: bool = True, trace_ctx=None, monitor=None,
                          grad_comm=None):
    """Gradient-accumulating train step (≙ GradientMergeOptimizer,
    reference ``jit/functional.py:225``): the gradients of
    ``accum_steps`` consecutive calls are summed in ``state["acc"]``; the
    optimizer applies their mean on every ``accum_steps``-th call
    (``state["acc_count"]``), and ``grad_comm`` with it.  Same signature
    as :func:`make_train_step`."""
    from ..distributed.grad_comm import comm_info
    from ..telemetry import instrument_train_step

    step, state0, params0, policy = _build(
        layer, loss_fn, optimizer, donate, trace_ctx, grad_comm,
        accum_steps=max(int(accum_steps), 1))
    comm = comm_info(params0, policy)
    if comm is not None:
        # the exchange runs every accum_steps-th call: amortize so the
        # per-step comm events stay truthful (ratio unchanged)
        comm = dict(comm, pre_bytes=comm["pre_bytes"] // accum_steps,
                    post_bytes=max(comm["post_bytes"] // accum_steps, 1))
    return instrument_train_step(step, monitor, "accum_train_step",
                                 comm=comm), state0


def make_eval_step(layer, loss_fn=None):
    """``step(params, buffers, inputs, labels=None) -> (out, loss)``: the
    layer in eval mode with ``params``/``buffers`` swapped in, no
    gradients; ``loss`` None without ``loss_fn`` or ``labels`` (reference
    ``jit/functional.py:307``)."""
    def step(params, buffers, inputs, labels=None):
        was = layer.training
        layer.eval()
        try:
            with torch.no_grad():
                out = torch.func.functional_call(
                    layer, {**params, **buffers}, tuple(inputs))
                main = out[0] if isinstance(out, (list, tuple)) else out
                if loss_fn is None or labels is None:
                    return main, None
                return main, loss_fn(main, *labels)
        finally:
            layer.train(was)
    return step


def sync_state_to_layer(layer, state) -> None:
    """Write a functional state's params and buffers into the layer's own
    tensors (reference ``jit/functional.py:334``; a ``__frozen__.`` buffer
    name is a frozen parameter there)."""
    named_p = dict(layer.named_parameters())
    named_b = dict(layer.named_buffers())
    with torch.no_grad():
        for name, val in state["params"].items():
            if named_p[name] is not val:
                named_p[name].copy_(val)
        for name, val in state["buffers"].items():
            if name.startswith("__frozen__."):
                dst = named_p[name[len("__frozen__."):]]
            else:
                dst = named_b[name]
            if dst is not val:
                dst.copy_(val)


__all__ = ["fold_in_step_key", "make_train_step", "make_accum_train_step",
           "make_eval_step", "sync_state_to_layer"]
