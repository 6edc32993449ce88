"""A hand kernel's share of its roofline, from a traced run: the least
time its calls could take on the card (`peaks.py`, and the kernel's own
file here for the work of one call) over the device time of its launches.
"""

from __future__ import annotations

import re

from benchmark.load import module
from benchmark.roofline.peaks import least_seconds


def share(trace, kernel: str) -> float | None:
    """Percent of the roofline over the kernel's calls in the capture, or
    None when the capture holds none."""
    if trace is None:
        return None
    spec = module("roofline", kernel)
    shapes = trace.kernel_calls.get(spec.KERNEL)
    device_ns = sum(d for name, _, d in trace.kernels
                    if re.search(spec.TRACE_NAMES, name))
    if not shapes or not device_ns:
        return None
    least = sum(least_seconds(*spec.work(shape))[0] for shape in shapes)
    return 100.0 * least / (device_ns * 1e-9)
