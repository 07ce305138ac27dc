"""Case registry: the ported cases as declarative configs."""

from __future__ import annotations

from typing import Callable

from lbm_tpu_torch.engine.spec import CaseSpec

_REGISTRY: dict[str, Callable[..., CaseSpec]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _load_all() -> None:
    # imported for their registration side effect, lazily to avoid cycles
    from lbm_tpu_torch.cases import lid_driven_cavity, poiseuille  # noqa: F401


def get_case(name: str, **kwargs) -> CaseSpec:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown case {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_cases() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


__all__ = ["register", "get_case", "list_cases"]
