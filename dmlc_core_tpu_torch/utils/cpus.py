"""Usable-CPU detection for sizing parse fan-outs (the port of
``dmlc_core_tpu/utils/cpus.py``).

``os.cpu_count()`` reports the HOST's core count, which over-provisions
thread pools inside containers: a cgroup cpu quota (cpu.max / cfs_quota)
or a restricted affinity mask can leave a process with a fraction of the
host's cores. ``available_cpus()`` returns the effective parallelism:

    min(affinity mask size, cgroup cpu quota, os.cpu_count())

``parse_threads()`` applies the ``DMLC_PARSE_THREADS`` env override on
top, the one knob for every parse fan-out (text parser pools and the
fused sub-shard producers).
"""

from __future__ import annotations

import math
import os
from typing import Optional

__all__ = ["available_cpus", "cgroup_cpu_quota", "parse_threads"]

# cgroup v2 unified mount and the v1 cpu controller roots; the
# process's OWN cgroup (from /proc/self/cgroup) is resolved against
# these — a fixed root path alone misses quotas in the common
# non-namespaced container setups (docker --cgroupns=host, systemd
# CPUQuota slices), where the root cgroup has no cpu.max at all
_CGROUP_V2_CPU_MAX = "/sys/fs/cgroup/cpu.max"
_CGROUP_V1_QUOTA = "/sys/fs/cgroup/cpu/cpu.cfs_quota_us"
_CGROUP_V1_PERIOD = "/sys/fs/cgroup/cpu/cpu.cfs_period_us"
_PROC_SELF_CGROUP = "/proc/self/cgroup"


def _read_first_line(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.readline().strip()
    except OSError:
        return None


def _self_cgroup_paths():
    """(v2_path, v1_cpu_path) of THIS process from /proc/self/cgroup
    (either may be None). v2 entries are ``0::<path>``; v1 cpu entries
    are ``<n>:cpu[,...]:<path>``."""
    v2 = v1 = None
    try:
        with open(_PROC_SELF_CGROUP) as f:
            for line in f:
                parts = line.strip().split(":", 2)
                if len(parts) != 3:
                    continue
                hid, controllers, path = parts
                if hid == "0" and controllers == "":
                    v2 = path
                elif "cpu" in controllers.split(","):
                    v1 = path
    except OSError:
        pass
    return v2, v1


def _quota_from_cpu_max(line: Optional[str]) -> Optional[float]:
    """Parse a v2 ``cpu.max`` line: ``"<quota> <period>"``; ``max``
    means unlimited."""
    if not line:
        return None
    parts = line.split()
    if len(parts) == 2 and parts[0] != "max":
        try:
            quota, period = int(parts[0]), int(parts[1])
            if quota > 0 and period > 0:
                return quota / period
        except ValueError:
            pass
    return None


def _ancestor_dirs(rel: str):
    """"/a/b/c" → ["a/b/c", "a/b", "a", ""] (nearest first; "" = root)."""
    rel = rel.strip("/")
    out = []
    while rel:
        out.append(rel)
        rel = rel.rpartition("/")[0]
    out.append("")
    return out


def cgroup_cpu_quota() -> Optional[float]:
    """Fractional CPUs allowed by the cgroup cpu controller, or None.

    v2: ``cpu.max`` holds ``"<quota> <period>"`` (or ``"max <period>"``
    for unlimited), checked for the process's own cgroup and every
    ancestor up to the root (the effective limit is the min over the
    hierarchy); v1: quota/period ride separate cfs files with -1 meaning
    unlimited. A 0.5-CPU quota is real and returned as 0.5 — callers
    ceil it so a throttled container still gets one thread.
    """
    v2_self, v1_self = _self_cgroup_paths()
    v2_root = os.path.dirname(_CGROUP_V2_CPU_MAX)
    quotas = []
    for rel in _ancestor_dirs(v2_self or ""):
        path = os.path.join(v2_root, rel, "cpu.max") if rel else (
            _CGROUP_V2_CPU_MAX
        )
        q = _quota_from_cpu_max(_read_first_line(path))
        if q is not None:
            quotas.append(q)
    if quotas:
        return min(quotas)
    v1_root = os.path.dirname(_CGROUP_V1_QUOTA)
    for rel in _ancestor_dirs(v1_self or ""):
        d = os.path.join(v1_root, rel) if rel else v1_root
        quota_s = _read_first_line(os.path.join(d, "cpu.cfs_quota_us"))
        period_s = _read_first_line(os.path.join(d, "cpu.cfs_period_us"))
        if quota_s and period_s:
            try:
                quota, period = int(quota_s), int(period_s)
                if quota > 0 and period > 0:
                    quotas.append(quota / period)
            except ValueError:
                pass
    return min(quotas) if quotas else None


def available_cpus() -> int:
    """CPUs this PROCESS may actually run on (>= 1).

    min over the three limits that apply to a containerized run: the
    scheduler affinity mask (taskset/k8s cpuset), the cgroup cpu quota
    (k8s cpu limits), and the host core count. Fractional quotas are
    ceiled: a 0.5-CPU container still runs one thread.
    """
    n = os.cpu_count() or 1
    getaffinity = getattr(os, "sched_getaffinity", None)
    if getaffinity is not None:
        try:
            n = min(n, len(getaffinity(0)) or 1)
        except OSError:
            pass
    quota = cgroup_cpu_quota()
    if quota is not None:
        n = min(n, max(1, math.ceil(quota)))
    return max(1, n)


def parse_threads(requested: Optional[int] = None) -> int:
    """Effective parse fan-out: ``DMLC_PARSE_THREADS`` wins, then its
    legacy alias ``DMLC_TPU_PARSER_THREADS``, then ``requested`` capped
    at ``available_cpus()``, then every available CPU (host cores idle
    while the device runs the step, so the parser gets all of them)."""
    env = (os.environ.get("DMLC_PARSE_THREADS")
           or os.environ.get("DMLC_TPU_PARSER_THREADS"))
    if env:
        return max(1, int(env))
    avail = available_cpus()
    if requested is None:
        return avail
    return max(1, min(requested, avail))
