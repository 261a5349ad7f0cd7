"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Each optimizer defines one pure update rule ``_rule(param, grad, slots,
lr, step) -> (new_param, new_slots)`` used by both halves:

- the eager half: ``step()`` reads each parameter's ``.grad`` and writes
  the new value into the parameter under ``no_grad``; its slots live on
  the optimizer (``state_dict``/``set_state_dict``);
- the functional half: ``init_state``/``update`` over a dict of named
  tensors, which is what the train step consumes.

``learning_rate`` is a float or an ``lr.LRScheduler``; ``grad_clip`` one of
``nn.clip``'s clips, applied to the gradients in both halves.
``parameters`` holds tensors, ``(name, tensor)`` pairs (what
``named_parameters()`` yields: the names Lars's exclusion and the
``state_dict`` keys read, where the reference reads ``Parameter.name``),
or parameter groups (dicts with ``"params"``, flattened).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .lr import LRScheduler


def _f32(x) -> torch.Tensor:
    """A 0-dim float32 CPU tensor (it broadcasts into tensors on any
    device without a copy)."""
    return torch.as_tensor(x, dtype=torch.float32).reshape(())


class Optimizer:
    _decoupled_wd = False  # AdamW-style decoupled decay overrides to True
    # a rule that needs the parameter's identity (Lars's
    # exclude_from_weight_decay) sets this; it then receives
    # ``param_name``: the name the parameter was given with eagerly, the
    # dict key functionally
    _wants_param_name = False
    # a rule that reduces over the whole parameter (Lamb's and Lars's
    # trust-ratio norms) sets this: it is not valid on a flat shard that
    # spans parameters
    _per_tensor_norms = False

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        items = list(parameters) if parameters is not None else None
        if items and isinstance(items[0], dict):
            items = [p for g in items for p in g["params"]]
        # a torch tensor carries no name: ``(name, param)`` pairs (as
        # ``named_parameters()`` gives them) name their parameter
        self._names: Dict[int, str] = {}
        self._parameter_list: Optional[List[torch.Tensor]] = None
        if items is not None:
            self._parameter_list = []
            for item in items:
                if isinstance(item, tuple):
                    self._names[id(item[1])], item = item
                self._parameter_list.append(item)
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        if isinstance(weight_decay, float):
            from ..regularizer import L2Decay
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        # eager slots: id(param) -> {slot: tensor}
        self._accum: Dict[int, Dict[str, Any]] = {}
        self._step_count = 0

    # ------------------------------------------------------------------ LR
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when learning rate is a "
                               "scheduler")
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # --------------------------------------------------------------- eager
    def _slots_for(self, p) -> Dict[str, Any]:
        key = id(p)
        if key not in self._accum:
            self._accum[key] = self._init_slots(p.detach())
        return self._accum[key]

    @torch.no_grad()
    def step(self):
        """One update of every parameter from its ``.grad``, in place.  A
        parameter with no gradient or ``requires_grad=False`` is left as
        it is; ``p.optimize_attr["learning_rate"]`` scales its rate."""
        params = self._parameter_list
        if params is None:
            raise ValueError("optimizer created without a parameter list; "
                             "pass parameters= or use the functional API")
        lr = self.get_lr()
        grads = {id(p): p.grad for p in params}
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_eager(params, grads)
        self._step_count += 1
        step = torch.tensor(self._step_count, dtype=torch.int32)
        for p in params:
            g = grads.get(id(p))
            if g is None or not p.requires_grad:
                continue
            data = p.detach()
            g = g.to(data.dtype)
            if self._use_coupled_wd():
                g = g + self._weight_decay.grad_term(data).to(g.dtype)
            plr = lr * getattr(p, "optimize_attr", {}).get("learning_rate",
                                                           1.0)
            extra = ({"param_name": self._names.get(id(p))}
                     if self._wants_param_name else {})
            new_p, new_slots = self._rule(data, g, self._slots_for(p),
                                          _f32(plr), step, **extra)
            p.copy_(new_p)
            self._accum[id(p)] = new_slots

    minimize_step = step

    def _use_coupled_wd(self) -> bool:
        """L2Decay folds into the gradient (decoupled optimizers skip)."""
        return self._weight_decay is not None and not self._decoupled_wd

    def clear_grad(self, set_to_zero: bool = False):
        """Drop every parameter's gradient (``set_to_zero`` is kept for the
        reference's signature and not read, as there)."""
        for p in self._parameter_list or ():
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # ---------------------------------------------------------- functional
    def _mp_applies(self, p) -> bool:
        return bool(self._multi_precision) and p.is_floating_point() \
            and p.element_size() == 2

    def _make_slots(self, p):
        """Slots for one param; multi_precision adds an fp32 master copy and
        keeps the moment buffers fp32 (the low-precision param is a cast of
        the master)."""
        if self._mp_applies(p):
            m = p.detach().float()
            slots = self._init_slots(m)
            slots["master"] = m
            return slots
        return self._init_slots(p.detach())

    def init_state(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The optimizer state for a dict of named parameters: ``{"step":
        int32 0-dim CPU tensor, "slots": {name: {slot: tensor}}}``."""
        return {"step": torch.zeros((), dtype=torch.int32),
                "slots": {n: self._make_slots(p) for n, p in params.items()}}

    def update(self, grads: Dict[str, Any], state: Dict[str, Any],
               params: Dict[str, Any], lr=None):
        """Pure functional update: returns (new_params, new_state); the
        inputs are not modified.  A missing or None gradient leaves its
        parameter and slots as they are."""
        if self._grad_clip is not None:
            grads = self._grad_clip._clip_pytree(grads)
        return self._apply_update(grads, state, params, lr)

    def _apply_update(self, grads: Dict[str, Any], state: Dict[str, Any],
                      params: Dict[str, Any], lr=None):
        """``update`` after the clip: the distributed steps clip over the
        whole gradient first, then update each rank's shards here."""
        lr = _f32(self.get_lr() if lr is None else lr)
        step = state["step"] + 1
        new_p, new_s = {}, {}
        for n, p in params.items():
            g, slots = grads.get(n), state["slots"][n]
            if g is None:
                new_p[n], new_s[n] = p, slots
                continue
            master = slots.get("master")
            tgt = master if master is not None else p
            g = g.to(tgt.dtype)
            if self._use_coupled_wd():
                g = g + self._weight_decay.grad_term(tgt).to(g.dtype)
            extra = {"param_name": n} if self._wants_param_name else {}
            if master is not None:
                inner = {k: v for k, v in slots.items() if k != "master"}
                new_master, new_inner = self._rule(master, g, inner, lr, step,
                                                   **extra)
                new_inner["master"] = new_master
                new_p[n], new_s[n] = new_master.to(p.dtype), new_inner
            else:
                new_p[n], new_s[n] = self._rule(p, g, slots, lr, step,
                                                **extra)
        return new_p, {"step": step, "slots": new_s}

    # ------------------------------------------------------------ state io
    def _param_names(self):
        """(name, param) of the eager parameter list: the name it was
        given with, else ``param_{i}``."""
        return [(self._names.get(id(p)) or f"param_{i}", p)
                for i, p in enumerate(self._parameter_list or ())]

    def state_dict(self) -> Dict[str, Any]:
        """``{"__step__": int, "{pname}.{slot}": tensor, ...}`` of the eager
        slots, with ``"LR_Scheduler"`` when the rate is a scheduler."""
        sd: Dict[str, Any] = {"__step__": self._step_count}
        for pname, p in self._param_names():
            for sname, val in (self._accum.get(id(p)) or {}).items():
                sd[f"{pname}.{sname}"] = val
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict: Dict[str, Any]):
        """Load eager slots keyed as ``state_dict`` writes them (values may
        be tensors on any device, numpy arrays, or objects with
        ``numpy()``); each lands on its parameter's device."""
        self._step_count = int(state_dict.get("__step__", 0))
        for pname, p in self._param_names():
            slots = self._init_slots(p.detach())
            found = False
            for sname in list(slots):
                key = f"{pname}.{sname}"
                if key in state_dict:
                    slots[sname] = _as_tensor(state_dict[key], p.device)
                    found = True
            if found:
                self._accum[id(p)] = slots
        if "LR_Scheduler" in state_dict and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])

    # ------------------------------------------------------------ subclass
    def _init_slots(self, p) -> Dict[str, Any]:
        return {}

    def _rule(self, p, g, slots, lr, step):
        raise NotImplementedError


def _as_tensor(val, device) -> torch.Tensor:
    """A copy of ``val`` on ``device``, its dtype kept."""
    if isinstance(val, torch.Tensor):
        return val.detach().to(device, copy=True)
    arr = np.array(val.numpy() if hasattr(val, "numpy") else val)
    return torch.from_numpy(arr).to(device)


def opt_state_from_numpy(np_state, device=None) -> Dict[str, Any]:
    """The port's optimizer state from a reference optimizer state as numpy
    (``{"step": int, "slots": {name: {slot: array}}}``, e.g. a
    ``jax.tree_util.tree_map(np.asarray, state["opt"])``) whose slots are
    float32, as they are for fp32 parameters and for ``multi_precision``
    masters.  Slots land on ``device`` (default cuda) as copies."""
    from .. import resolve_device

    dev = resolve_device(device)

    def tensor(a):
        arr = np.asarray(a)
        if arr.dtype != np.float32:
            raise ValueError(f"optimizer slots must be float32, got "
                             f"{arr.dtype}")
        return torch.from_numpy(arr.copy()).to(dev)

    return {"step": torch.tensor(int(np.asarray(np_state["step"])),
                                 dtype=torch.int32),
            "slots": {n: {k: tensor(v) for k, v in s.items()}
                      for n, s in np_state["slots"].items()}}
