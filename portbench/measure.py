"""What every driver measures around its window, and how it frees the
card for the reference: the sample judged, the profiler, the memory peak,
the card's clocks and power limit."""
from __future__ import annotations

import gc
import subprocess


def sample(rng, items, size_of, want: int, longest: bool):
    """Items drawn from ``rng`` until their sizes reach ``want``; with
    ``longest`` the largest item comes first."""
    order = list(rng.permutation(len(items)))
    if longest and items:
        big = max(range(len(items)), key=lambda i: size_of(items[i]))
        order.remove(big)
        order.insert(0, big)
    out, total = [], 0
    for i in order:
        if total >= want:
            break
        out.append(items[i])
        total += size_of(items[i])
    return out


def free(device) -> None:
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def profiler(trace: bool):
    """A warmed profiler for a traced run (its start-up is set-up)."""
    if not trace:
        return None
    from .trace import Profiler
    p = Profiler()
    p.warm()
    return p


def peak(device) -> int:
    import torch
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize()
    return int(max(torch.cuda.max_memory_allocated(i)
                   for i in range(torch.cuda.device_count())))


CLOCK_FIELDS = ("clocks.sm", "clocks.max.sm", "power.draw",
                "temperature.gpu", "clocks_throttle_reasons.active")


def clocks(device):
    """The card's SM clock (and its maximum) in MHz, power draw in W,
    temperature and throttle reasons as ``nvidia-smi`` reads them when the
    window has closed, or None."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=" + ",".join(CLOCK_FIELDS),
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
        return dict(zip(CLOCK_FIELDS, (v.strip() for v in out.split(","))))
    except (OSError, subprocess.SubprocessError):
        return None


def power_limit():
    """The card's power limit in W from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
