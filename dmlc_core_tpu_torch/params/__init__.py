"""Declarative parameters, registries, and config files (the port of
``dmlc_core_tpu/params``; reference: include/dmlc/parameter.h,
registry.h, config.h). No torch: these are host-side structs."""

from .parameter import Parameter, field, ParamError  # noqa: F401
from .registry import Registry, RegistryEntry  # noqa: F401
from .config import Config  # noqa: F401
