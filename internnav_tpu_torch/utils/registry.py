"""Generic decorator registry.

The reference repeats the same ~40-line registry pattern three times
(internnav/agent/base.py:6-37, internnav/env/base.py:6-54,
internnav/evaluator/base.py:6-39). Here it is factored once and reused.

Copy of internnav_tpu/utils/registry.py,
kept in the port so that it imports nothing of the JAX package (held
equal to it by tests/test_torch_evaluator.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterable, Optional, Type, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A named string → class registry with decorator registration.

    >>> agents = Registry("agent")
    >>> @agents.register("cma")
    ... class CmaAgent: ...
    >>> agents.get("cma") is CmaAgent
    True
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Type[T]] = {}

    def register(self, name: Optional[str] = None) -> Callable[[Type[T]], Type[T]]:
        def deco(cls: Type[T]) -> Type[T]:
            key = name or getattr(cls, "name", None) or cls.__name__
            if key in self._entries and self._entries[key] is not cls:
                raise ValueError(f"{self.kind} {key!r} already registered")
            self._entries[key] = cls
            cls.registered_name = key
            return cls

        return deco

    def get(self, name: str) -> Type[T]:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}"
            )
        return self._entries[name]

    def build(self, name: str, *args, **kwargs) -> T:
        return self.get(name)(*args, **kwargs)

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries
