"""What the two kernel tools share: seeded inputs, timing, argument parsing."""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def seeded(rng: np.random.Generator, shape, dtype, device) -> torch.Tensor:
    """0.05 * standard normal of `shape`, drawn with numpy (the draws of the
    JAX tools for the same seed and order), rounded to `dtype`."""
    x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    x = torch.from_numpy(x)
    return x.to(device=device, dtype=dtype)


def time_ms(fn: Callable[[], object], device: torch.device, iters: int,
            warmup: int = 2) -> float:
    """Median milliseconds of fn().  On a CUDA device: CUDA events around
    each call on the current stream, after `warmup` calls (device time).  On
    the CPU: the host clock (a dry run; not a device time)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(max(1, iters)):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def flag(argv: Sequence[str], name: str, default: Optional[int]):
    """The integer after `name` in argv, or `default`."""
    if name in argv:
        return int(argv[argv.index(name) + 1])
    return default


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (dry run: plain versions, host-clock times)"


def emit(rows: List[dict], row: dict, text: str) -> None:
    rows.append(row)
    print(text, flush=True)
