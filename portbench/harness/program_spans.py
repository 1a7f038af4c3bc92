"""The program's own spans (yourmt3_tpu_torch/utils/profiling.py), for the
readers of per-layer metrics. They are recorded only while a profiler
runs, so in a traced run they cover the traced songs or steps. A program
whose profiling module keeps no spans yields none, and every reader then
returns None."""

from __future__ import annotations

from typing import List, Optional


def spans() -> list:
    try:
        from yourmt3_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def named(name: str) -> list:
    return [sp for sp in spans() if sp.name == name]


def mean_host_ms(name: str) -> Optional[float]:
    """Mean host milliseconds of the spans called `name`."""
    got = named(name)
    return 1e-6 * sum(sp.t1_ns - sp.t0_ns for sp in got) / len(got) if got else None


def mean_device_ms(name: str) -> Optional[float]:
    """Mean device milliseconds (`device_ms`) of the spans called `name`."""
    got: List[float] = [sp.device_ms for sp in named(name)
                        if getattr(sp, "device_ms", None) is not None]
    return sum(got) / len(got) if got else None
