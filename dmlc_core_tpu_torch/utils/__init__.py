"""Shared helpers: CHECK machinery, device resolution, env access,
timers and the profiler hooks."""
