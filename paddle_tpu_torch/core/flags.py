"""Global flag registry (counterpart of ``paddle_tpu/core/flags.py``).

One flat dict of named flags, seeded from ``FLAGS_*`` environment variables
when a flag is defined and mutable at runtime (``set_flags``, the
``paddle.set_flags`` surface).  The port keeps its own copy because the
reference module cannot be imported without jax.

Only the flags the ported paths read are defined.  The reference's
``FLAGS_use_pallas_kernels`` kill switch and its two interpret-mode flags
(``FLAGS_fused_ln_interpret``, ``FLAGS_paged_attn_interpret``) have no
counterpart: the port picks a kernel or its plain version by the device of
the tensor it is given, and has no switch that turns a kernel off.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Mapping, Optional

_REGISTRY: Dict[str, "Flag"] = {}


class Flag:
    __slots__ = ("name", "value", "default", "help")

    def __init__(self, name: str, default: Any, help: str = ""):
        self.name = name
        self.default = default
        self.value = default
        self.help = help


def define_flag(name: str, default: Any, help: str = "") -> None:
    if name in _REGISTRY:
        return
    flag = Flag(name, default, help)
    env = os.environ.get(name)
    if env is not None:
        flag.value = _coerce(env, default)
    _REGISTRY[name] = flag


def _coerce(text: str, like: Any) -> Any:
    if isinstance(like, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(text)
    if isinstance(like, float):
        return float(text)
    return text


def set_flags(flags: Mapping[str, Any]) -> None:
    """Set one or more flags; an unknown name is defined on the spot."""
    for name, value in flags.items():
        if name not in _REGISTRY:
            define_flag(name, value)
        else:
            _REGISTRY[name].value = value


def get_flags(names: Optional[Iterable[str]] = None) -> Dict[str, Any]:
    """``{name: value}`` of the named flags (all of them for None)."""
    if names is None:
        return {k: f.value for k, f in _REGISTRY.items()}
    if isinstance(names, str):
        names = [names]
    return {n: _REGISTRY[n].value for n in names}


def flag(name: str) -> Any:
    return _REGISTRY[name].value


define_flag("FLAGS_seed", 0, "Global random seed (core.rng.seed sets it).")
define_flag("FLAGS_use_fused_ln", False,
            "Route BERT's LN + residual + dropout epilogue through the fused "
            "kernel (ops/fused.py); off by default, as in the reference.")
define_flag("FLAGS_use_fused_adamw", False,
            "Reserved for the flat fused AdamW sweep (ops/fused.py "
            "fused_adamw_flat); no trainer reads it, as in the reference.")
