"""Shared utilities: model size, running averages, step timing, logging and
dtype casts of state dicts.  Port of asva_tpu/utils.py; where that walks a
parameter pytree this takes an `nn.Module`, a state dict or any nesting of
dicts, lists and tuples of tensors."""
from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Optional

import torch


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


def get_model_size(params, unit: str = "M") -> float:
    """Number of parameters of a module or a tree of tensors, in K, M or B."""
    n = 0
    for p in _leaves(params):
        size = 1
        for s in p.shape:
            size *= int(s)
        n += size
    return n / {"K": 1e3, "M": 1e6, "B": 1e9}[unit]


class AverageMeter:
    """Windowed running average."""

    def __init__(self, window: Optional[int] = None):
        self.window = window
        self.reset()

    def reset(self):
        self._values = deque(maxlen=self.window)
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        value = float(value)
        self._values.append((value, n))
        self.sum += value * n
        self.count += n

    @property
    def avg(self) -> float:
        if self.window is None:
            return self.sum / max(self.count, 1)
        tot = sum(v * n for v, n in self._values)
        cnt = sum(n for _, n in self._values)
        return tot / max(cnt, 1)


class StepTimer:
    """Rolling steps per second over the last `window` steps.  The host
    clock only: the caller synchronises the device before each tick where
    the steps' device time is meant, and a tick may count several steps
    (a log boundary's); the newest tick is kept whatever its steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = deque()
        self.steps = deque()
        self.last = time.perf_counter()

    def tick(self, steps: int = 1) -> float:
        """Close an interval of `steps` steps; returns its seconds."""
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        self.times.append(dt)
        self.steps.append(steps)
        while len(self.steps) > 1 and sum(self.steps) > self.window:
            self.times.popleft()
            self.steps.popleft()
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return sum(self.steps) / sum(self.times)


def setup_logging(log_file: Optional[str] = None,
                  name: str = "asva_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
        # attach the file sink even when an earlier call configured the
        # stream handler: a second job in the process gets its own file
        path = os.path.abspath(log_file)
        have = any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == path
                   for h in logger.handlers)
        if not have:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def cast_floating(tree, dtype):
    """A copy of a state dict (or any nesting of dicts, lists and tuples)
    with every floating-point tensor cast to `dtype`; integer and bool
    tensors and other leaves pass through."""
    if isinstance(tree, dict):
        return type(tree)((k, cast_floating(v, dtype)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
