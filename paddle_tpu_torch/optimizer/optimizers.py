"""Concrete optimizers (counterpart of ``paddle_tpu/optimizer/optimizers.py``):
SGD, Momentum, Adam, AdamW, Adamax, Adagrad, Adadelta, RMSProp, Lamb and
Lars with Paddle's update rules written out, in the reference's dtypes.
Paddle's AdamW is not ``torch.optim.AdamW``: it decays first,
``p * (1 - lr * coeff)``, then takes the Adam step with ``lr_t = lr *
sqrt(1 - b2^t) / (1 - b1^t)`` and the unscaled ``eps`` added to ``sqrt(v)``.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer, _f32


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _rule(self, p, g, slots, lr, step):
        return p - lr.to(p.dtype) * g, slots


class Momentum(Optimizer):
    """Heavy-ball momentum, optionally Nesterov."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step):
        mu = torch.tensor(self._momentum, dtype=p.dtype)
        v = slots["velocity"] * mu + g
        if self._nesterov:
            new_p = p - lr.to(p.dtype) * (g + mu * v)
        else:
            new_p = p - lr.to(p.dtype) * v
        return new_p, {"velocity": v}


class Adam(Optimizer):
    """lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t); p -= lr_t * m / (sqrt(v) +
    eps)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step):
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        t = step.to(torch.float32)
        dt = p.dtype
        m = b1.to(dt) * slots["moment1"] + (1 - b1).to(dt) * g
        v = b2.to(dt) * slots["moment2"] + (1 - b2).to(dt) * (g * g)
        lr_t = lr * torch.sqrt(1 - torch.pow(b2, t)) / (1 - torch.pow(b1, t))
        denom = torch.sqrt(v.float()) + self._epsilon
        new_p = p - (lr_t * m.float() / denom).to(dt)
        return new_p, {"moment1": m, "moment2": v}


class AdamW(Adam):
    """Decoupled weight decay: p *= (1 - lr * coeff), then the Adam step.
    On this functional path the decay applies to every parameter
    (``apply_decay_param_fun`` and ``lr_ratio`` are kept, not read, as in
    the reference's functional path)."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        from ..regularizer import L2Decay
        wd = (L2Decay(weight_decay) if isinstance(weight_decay, float)
              else weight_decay)
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters, wd,
                         grad_clip, lazy_mode, multi_precision, name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _rule(self, p, g, slots, lr, step):
        coeff = self._weight_decay.coeff if self._weight_decay is not None \
            else 0.0
        p = p * (1 - lr.to(p.dtype) * torch.tensor(coeff, dtype=p.dtype))
        return super()._rule(p, g, slots, lr, step)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment": torch.zeros_like(p), "inf_norm": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step):
        b1 = torch.tensor(self._beta1, dtype=p.dtype)
        b2 = torch.tensor(self._beta2, dtype=p.dtype)
        t = step.to(torch.float32)
        m = b1 * slots["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * slots["inf_norm"], g.abs() + self._epsilon)
        lr_t = (lr / (1 - torch.pow(b1.float(), t))).to(p.dtype)
        return p - lr_t * m / u, {"moment": m, "inf_norm": u}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _init_slots(self, p):
        return {"moment": torch.full_like(p, self._init_value)}

    def _rule(self, p, g, slots, lr, step):
        moment = slots["moment"] + g * g
        new_p = p - lr.to(p.dtype) * g / (torch.sqrt(moment) + self._epsilon)
        return new_p, {"moment": moment}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._epsilon, self._rho = epsilon, rho

    def _init_slots(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step):
        rho = torch.tensor(self._rho, dtype=p.dtype)
        eps = torch.tensor(self._epsilon, dtype=p.dtype)
        sg = rho * slots["avg_squared_grad"] + (1 - rho) * g * g
        update = -torch.sqrt(slots["avg_squared_update"] + eps) \
            / torch.sqrt(sg + eps) * g
        su = rho * slots["avg_squared_update"] + (1 - rho) * update * update
        return p + lr.to(p.dtype) * update, \
            {"avg_squared_grad": sg, "avg_squared_update": su}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name=name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots(self, p):
        slots = {"mean_square": torch.zeros_like(p),
                 "momentum": torch.zeros_like(p)}
        if self._centered:
            slots["mean_grad"] = torch.zeros_like(p)
        return slots

    def _rule(self, p, g, slots, lr, step):
        rho = torch.tensor(self._rho, dtype=p.dtype)
        ms = rho * slots["mean_square"] + (1 - rho) * g * g
        out = {"mean_square": ms}
        if self._centered:
            mg = rho * slots["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
            out["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = torch.tensor(self._momentum, dtype=p.dtype) * slots["momentum"] \
            + lr.to(p.dtype) * g / denom
        out["momentum"] = mom
        return p - mom, out


class Lamb(Optimizer):
    """Layerwise trust ratio times the Adam update, in fp32.
    ``exclude_from_weight_decay_fn`` is stored and not read, and
    ``multi_precision`` is not passed on, both as in the reference
    (``ROADMAP.md`` §C)."""

    _per_tensor_norms = True

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         name=name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step):
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        t = step.to(torch.float32)
        g32, p32 = g.float(), p.float()
        m = b1 * slots["moment1"].float() + (1 - b1) * g32
        v = b2 * slots["moment2"].float() + (1 - b2) * g32 * g32
        m_hat = m / (1 - torch.pow(b1, t))
        v_hat = v / (1 - torch.pow(b2, t))
        update = m_hat / (torch.sqrt(v_hat) + self._epsilon) \
            + self._lamb_wd * p32
        p_norm = torch.linalg.vector_norm(p32)
        u_norm = torch.linalg.vector_norm(update)
        trust = torch.where((p_norm > 0) & (u_norm > 0), p_norm / u_norm, 1.0)
        new_p = p32 - lr.to(p32.device) * trust * update
        return new_p.to(p.dtype), {"moment1": m.to(p.dtype),
                                   "moment2": v.to(p.dtype)}


class Lars(Optimizer):
    """LARS momentum:
    local_lr = lr * lars_coeff * ||p|| / (||g|| + wd * ||p|| + eps)
    v        = mu * v + local_lr * (g + wd * p);   p -= v
    A zero ||p|| or ||g|| takes the plain momentum rate ``lr``; a parameter
    whose name contains one of ``exclude_from_weight_decay`` takes wd 0."""

    _wants_param_name = True
    _per_tensor_norms = True

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, multi_precision=False, name=None,
                 exclude_from_weight_decay=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon
        self._exclude = list(exclude_from_weight_decay or [])

    def _init_slots(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _rule(self, p, g, slots, lr, step, param_name=None):
        mu = _f32(self._momentum)
        wd = self._lars_wd
        if param_name is not None and any(
                ex in str(param_name) for ex in self._exclude):
            wd = 0.0
        p32, g32 = p.float(), g.float()
        lr = lr.to(p32.device)
        p_norm = torch.linalg.vector_norm(p32)
        g_norm = torch.linalg.vector_norm(g32)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * p_norm
            / (g_norm + wd * p_norm + self._epsilon),
            lr)
        v = mu * slots["velocity"].float() + local_lr * (g32 + wd * p32)
        return (p32 - v).to(p.dtype), {"velocity": v.to(p.dtype)}


LarsMomentum = Lars
