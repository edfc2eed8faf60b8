"""Custom-op registry: named ops with per-target implementations.

PyTorch counterpart of ``bm25_tpu/ops/registry.py``.  A target is a
``torch.device`` type ("cuda", "cpu") or ``"*"`` for an implementation
that serves every device (the built-in ops pick their kernel or plain
twin from their tensors' device themselves).  ``custom(name, ...)``
resolves the implementation for the target named with ``target=``, or
else for the type of a ``device=`` parameter (a ``torch.device`` or a
string, passed on to the op: the way to place an op with no tensor
argument, such as ``arange``), or else for the device of the first
tensor argument (or tensor in a list or tuple argument); there is no
default device to fall back on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

_REGISTRY: dict[str, "OpEntry"] = {}

GENERIC = "*"


@dataclass
class OpEntry:
    name: str
    impls: dict[str, Callable] = field(default_factory=dict)

    def resolve(self, target: str) -> Callable:
        fn = self.impls.get(target) or self.impls.get(GENERIC)
        if fn is None:
            raise KeyError(
                f"op {self.name!r} has no implementation for target "
                f"{target!r} (have {sorted(self.impls)})"
            )
        return fn


def register_op(name: str, target: str = GENERIC):
    """Decorator: register ``fn`` as the ``target`` implementation of
    ``name``; target is "*" (any device), "cuda", "cpu" or another
    ``torch.device`` type."""

    def deco(fn: Callable) -> Callable:
        entry = _REGISTRY.setdefault(name, OpEntry(name))
        if target in entry.impls:
            raise ValueError(f"duplicate registration: {name!r} for {target!r}")
        entry.impls[target] = fn
        return fn

    return deco


def get_op(name: str, target: str) -> Callable:
    """Resolve a registered op for a target (a ``torch.device`` type)."""
    try:
        entry = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown op {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return entry.resolve(target)


def _target_of(args, params) -> str:
    if params.get("device") is not None:
        return torch.device(params["device"]).type
    for x in (*args, *params.values()):
        for t in (x if isinstance(x, (list, tuple)) else (x,)):
            if isinstance(t, torch.Tensor):
                return t.device.type
    raise ValueError("custom(): no tensor argument to take the target from; "
                     "pass target= or device=")


def custom(name: str, *args, target: str | None = None, **params):
    """Invoke a registered op by name, for ``target``, else the type of the
    ``device=`` parameter (passed on to the op), else the device of the
    first tensor argument."""
    if target is None:
        target = _target_of(args, params)
    return get_op(name, target)(*args, **params)


def list_ops() -> list[str]:
    return sorted(_REGISTRY)
