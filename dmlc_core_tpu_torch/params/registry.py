"""Named-factory registry: the plugin system (the port of
``dmlc_core_tpu/params/registry.py``).

Reference: include/dmlc/registry.h. The reference keeps one mutex-guarded
singleton Registry<EntryType> per entry type (registry.h:26-126) with fluent
metadata on entries (FunctionRegEntryBase, registry.h:150-226) and macro
registration (DMLC_REGISTRY_ENABLE/REGISTER, registry.h:234-252). Python
import side effects replace the static-initializer FILE_TAG/LINK_TAG trick
(registry.h:263-308).

The port's parsers, filesystems and launcher backends keep their own
tables (``data/__init__.py``, ``io/filesystem.py``, ``tracker/backends``);
user code registers its own factories here.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

from ..utils.logging import Error

T = TypeVar("T")

__all__ = ["Registry", "RegistryEntry"]


class RegistryEntry(Generic[T]):
    """Entry with fluent metadata (reference FunctionRegEntryBase,
    registry.h:150-226)."""

    def __init__(self, name: str, body: Callable[..., T]) -> None:
        self.name = name
        self.body = body
        self.description = ""
        self.arguments: List[Dict[str, str]] = []
        self.return_type = ""

    def describe(self, description: str) -> "RegistryEntry[T]":
        self.description = description
        return self

    def add_argument(self, name: str, type: str, description: str) -> "RegistryEntry[T]":
        self.arguments.append(
            {"name": name, "type": type, "description": description}
        )
        return self

    def set_return_type(self, t: str) -> "RegistryEntry[T]":
        self.return_type = t
        return self

    def __call__(self, *args: Any, **kwargs: Any) -> T:
        return self.body(*args, **kwargs)


class Registry(Generic[T]):
    """Name → factory registry (reference Registry<T>, registry.h:26-126).

    Instantiate one per plugin kind::

        PARSER_REGISTRY = Registry("parser")

        @PARSER_REGISTRY.register("libsvm")
        def make_libsvm(source, params): ...
    """

    _instances: Dict[str, "Registry"] = {}
    _instances_lock = threading.Lock()

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._lock = threading.Lock()
        self._entries: Dict[str, RegistryEntry[T]] = {}
        with Registry._instances_lock:
            if kind in Registry._instances:
                raise Error(f"Registry {kind!r} already exists; use Registry.get()")
            Registry._instances[kind] = self

    @classmethod
    def get(cls, kind: str) -> "Registry":
        """Singleton access (reference Registry::Get, registry.h:235-241)."""
        with cls._instances_lock:
            reg = cls._instances.get(kind)
        if reg is None:
            raise Error(f"No registry of kind {kind!r}")
        return reg

    def register(
        self, name: str, override: bool = False
    ) -> Callable[[Callable[..., T]], Callable[..., T]]:
        """Decorator form of __REGISTER__ (reference registry.h:89-105)."""

        def deco(body: Callable[..., T]) -> Callable[..., T]:
            self.add(name, body, override=override)
            return body

        return deco

    def add(
        self, name: str, body: Callable[..., T], override: bool = False
    ) -> RegistryEntry[T]:
        with self._lock:
            if name in self._entries and not override:
                raise Error(f"{self.kind} {name!r} already registered")
            entry = RegistryEntry(name, body)
            self._entries[name] = entry
            return entry

    def find(self, name: str) -> Optional[RegistryEntry[T]]:
        """Reference Registry::Find (registry.h:48-56); None when missing."""
        with self._lock:
            return self._entries.get(name)

    def lookup(self, name: str) -> RegistryEntry[T]:
        entry = self.find(name)
        if entry is None:
            raise Error(
                f"Unknown {self.kind} {name!r}; registered: {sorted(self.names())}"
            )
        return entry

    def create(self, name: str, *args: Any, **kwargs: Any) -> T:
        return self.lookup(name)(*args, **kwargs)

    def names(self) -> List[str]:
        """Reference ListAllNames (registry.h:40-46)."""
        with self._lock:
            return list(self._entries)

    def remove(self, name: str) -> None:
        with self._lock:
            self._entries.pop(name, None)
