"""Process and device memory usage (the CLI's ``-v`` line).

Port of slam_plus_plus_tpu/utils/memusage.py (reference CProcessMemInfo,
include/slam/MemUsage.h:54): the host's current and peak resident set from
/proc, and, where the device is a CUDA card, PyTorch's allocator counters
for it in place of the JAX package's per-device memory_stats().
"""

from __future__ import annotations

import resource
from typing import Dict

import torch


def process_memory() -> Dict[str, int]:
    """Current and peak RSS in bytes: VmRSS and VmHWM from /proc, the peak
    no lower than getrusage's (some kernels report no VmHWM)."""
    out = {"rss": 0, "peak_rss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss"] = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    out["peak_rss"] = max(out["peak_rss"], int(line.split()[1]) * 1024)
    except OSError:
        pass
    return out


def device_memory(device) -> Dict[str, Dict[str, int]]:
    """{device name: bytes in use, peak bytes in use since the last
    reset_peak_memory_stats, the card's total} for a CUDA device; {} for
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {f"cuda:{index}": {
        "bytes_in_use": torch.cuda.memory_allocated(index),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(index),
        "bytes_limit": torch.cuda.get_device_properties(index).total_memory}}


def format_report(device="cpu") -> str:
    """One line: the host RSS and, on a card, its allocator's use, peak and
    total (the JAX CLI's verbose line)."""
    pm = process_memory()

    def mb(x):
        return f"{x / (1 << 20):.1f} MB"

    parts = [f"memory: host rss {mb(pm['rss'])} (peak {mb(pm['peak_rss'])})"]
    for dev, st in device_memory(device).items():
        parts.append(f"{dev}: {mb(st['bytes_in_use'])} in use (peak "
                     f"{mb(st['peak_bytes_in_use'])}, limit {mb(st['bytes_limit'])})")
    return "; ".join(parts)
