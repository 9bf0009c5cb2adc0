"""Flags and helpers shared by the port's CLIs."""
from __future__ import annotations

import argparse

import torch


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the plain versions of the kernels in float32)")


def compute_dtype(device: str) -> torch.dtype:
    """The generation dtype: bfloat16 on the card, float32 on the CPU
    (where the plain versions run)."""
    return torch.float32 if torch.device(device).type == "cpu" \
        else torch.bfloat16
