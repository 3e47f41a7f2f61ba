"""Shared helpers: CHECK machinery and logging, device resolution, env
access, timers and the profiler hooks."""

from .logging import (  # noqa: F401
    Error,
    check,
    check_eq,
    check_ne,
    check_lt,
    check_le,
    check_gt,
    check_ge,
    check_notnull,
    log_info,
    log_warning,
    log_error,
    log_fatal,
    log_debug,
    set_log_sink,
)
from .timer import get_time, Timer  # noqa: F401
from .env import get_env, set_env  # noqa: F401
from .common import split_string, hash_combine, ThreadException  # noqa: F401
from .profiler import annotate, trace  # noqa: F401
