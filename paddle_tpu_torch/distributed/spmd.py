"""The train step, one-device arm (counterpart of
``paddle_tpu/distributed/spmd.py`` ``_make_gspmd_step`` /
``make_gspmd_step_from_loss``).  Meshes of more than one device wait for
the distributed slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn


class _Thunk(nn.Module):
    """Holds ``layer`` so ``torch.func.functional_call`` can swap its
    parameters for the duration of one call of a thunk."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, fn):
        return fn()


def make_gspmd_step_from_loss(loss_of, params0, optimizer, mesh=None,
                              layer=None, zero_stage: int = 0,
                              donate: bool = True, grad_comm=None):
    """Train step for a functional loss on one device (``mesh`` None):
    ``loss_of(params, *batch) -> scalar``.  Returns ``(step, state0)`` with
    ``step(state, lr, *batch) -> (state, loss)`` and state ``{"params",
    "opt", "buffers"}``.

    ``params0`` is a dict of leaf tensors that require grad (a model's own
    parameters: the state holds them, not copies), and the loss reads
    ``layer``'s (the model's) parameters.

    ``donate=True``: the step computes the loss and its gradients, applies
    ``optimizer.update``, and writes the new parameters and optimizer slots
    INTO the state's tensors under ``no_grad`` — the counterpart of the
    reference's donated state, so the model that owns the parameters sees
    every update and no second copy outlives the step.  The returned state
    is the same dict.

    ``donate=False``: the step computes on the given state's tensors
    (``torch.func.functional_call`` swaps them into ``layer`` for the
    forward and the backward), leaves that state and the model's own
    parameters untouched, and returns a fresh state that shares no tensor
    with the one it was given."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is the distributed slice of the port (ROADMAP A7)")
    if zero_stage:
        raise NotImplementedError("zero_stage > 0 is not ported yet "
                                  "(ROADMAP A7)")
    if grad_comm not in (None, "fp32"):
        raise NotImplementedError(f"grad_comm {grad_comm!r} is not ported "
                                  f"yet (ROADMAP A7)")
    if not donate and layer is None:
        raise ValueError("donate=False needs the layer whose parameters the "
                         "loss reads")
    state0 = {"params": dict(params0), "opt": optimizer.init_state(params0),
              "buffers": {}}
    trainable = [n for n, p in params0.items() if p.requires_grad]

    def donated(state, lr, *batch):
        params = state["params"]
        loss = loss_of(params, *batch)
        grads = dict(zip(trainable, torch.autograd.grad(
            loss, [params[n] for n in trainable])))
        with torch.no_grad():
            new_p, new_opt = optimizer.update(grads, state["opt"], params,
                                              lr=lr)
            for n, p in params.items():
                if new_p[n] is not p:
                    p.copy_(new_p[n])
            slots = state["opt"]["slots"]
            for n, s in new_opt["slots"].items():
                for k, v in s.items():
                    if v is not slots[n][k]:
                        slots[n][k].copy_(v)
            state["opt"]["step"] = new_opt["step"]
        return state, loss.detach()

    holder = _Thunk(layer) if layer is not None else None

    def kept(state, lr, *batch):
        leaves = {n: p.detach().requires_grad_(n in trainable)
                  for n, p in state["params"].items()}

        def run():
            loss = loss_of(leaves, *batch)
            return loss, torch.autograd.grad(
                loss, [leaves[n] for n in trainable])

        # the backward runs inside the call too: a recomputed (remat)
        # block must read the same swapped-in tensors
        loss, g = torch.func.functional_call(
            holder, {f"layer.{n}": t for n, t in leaves.items()}, (run,))
        with torch.no_grad():
            new_p, new_opt = optimizer.update(dict(zip(trainable, g)),
                                              state["opt"], leaves, lr=lr)
            old = state["opt"]["slots"]
            fresh = {"params": {n: (v.clone() if v is leaves[n] else v)
                                for n, v in new_p.items()},
                     "opt": {"step": new_opt["step"], "slots": {
                         n: {k: (v.clone() if v is old[n].get(k) else v)
                             for k, v in s.items()}
                         for n, s in new_opt["slots"].items()}},
                     "buffers": dict(state["buffers"])}
        return fresh, loss.detach()

    return (donated if donate else kept), state0
