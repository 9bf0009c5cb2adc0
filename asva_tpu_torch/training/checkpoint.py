"""Checkpointing with the reference's step/milestone retention policy.

Port of asva_tpu/training/checkpoint.py with the same directory layout:

    <dir>/checkpoint-N/state.pt              full train state (exact resume)
    <dir>/checkpoint-N/modules/<name>.pt     per-module state dicts
    <dir>/checkpoint-N/modules_config.json   architectures of the exports
    <dir>/checkpoint-N/extra.json            small host-side state

Save every `checkpointing_steps`; once a newer checkpoint is complete, the
previous one is deleted unless its step is a multiple of `milestone_steps`,
so a crash mid-write never leaves zero usable checkpoints.  Storage is
`torch.save` of nested dicts of tensors and numbers, written to a temporary
name and renamed; `state.pt` is renamed last, and only a directory that
holds it counts as a checkpoint.  Loading is
`torch.load(weights_only=True)`.  Saves are synchronous, so `close()`, which
the train loops call before they return, has nothing left to wait for.

Across processes (asva_tpu/training/checkpoint.py:52-69, :111, :165, :181)
every rank calls `save` with its replica of the same state, and only rank 0,
the primary, writes the files and applies retention; `save` returns on every
rank once the primary's renames have landed (a bounded barrier on the host
group).  `restore_latest` restores the step that rank 0 finds, broadcast to
the others, so the ranks cannot disagree over a directory being written.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import torch

from ..parallel import multihost


def _write_atomic(path: str, write) -> None:
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp")
    write(tmp)
    os.replace(tmp, path)


def _write_json(path: str, obj: Any, **kw) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f, **kw)
    _write_atomic(path, write)


class CheckpointManager:
    def __init__(self, directory: str, checkpointing_steps: int = 1000,
                 milestone_steps: int = 0,
                 module_configs: Optional[dict] = None):
        """module_configs: JSON-serializable {module_name: config_dict},
        written as checkpoint-N/modules_config.json alongside every module
        export, so that an export is self-describing and
        `runtime.load_animation_pipeline` can rebuild the architecture."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.checkpointing_steps = checkpointing_steps
        self.milestone_steps = milestone_steps
        self.module_configs = module_configs
        self._last_saved: Optional[int] = None

    # -- paths --
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}")

    def existing_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = re.match(r"^checkpoint-(\d+)$", name)
            # a complete save has its renamed state.pt; a crash mid-write
            # leaves only temporary names -> not restorable
            if m and os.path.isfile(os.path.join(self.directory, name,
                                                 "state.pt")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.existing_steps()
        return steps[-1] if steps else None

    def is_milestone(self, step: int) -> bool:
        return (self.milestone_steps > 0
                and step % self.milestone_steps == 0)

    # -- save/restore --
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.checkpointing_steps == 0

    def save(self, step: int, state: dict, force: bool = False,
             modules: Optional[dict] = None,
             extra: Optional[dict] = None) -> bool:
        """Save the full train state (`TrainState.state_dict()` or any
        nested dict of tensors and numbers); `modules` optionally adds
        per-module state-dict exports under checkpoint-N/modules/<name>.pt
        (exact-resume state + inference module exports).  `extra` is a small
        JSON-serializable dict (data-loader cursor, host RNG, ...)
        recoverable via `restore_extra`.  Returns whether it saved."""
        if not force and not self.should_save(step):
            return False
        if step == self._last_saved:
            return False   # idempotent: the loop's periodic save at
            #                max_steps + the final force-save are one step
        if self._last_saved is None:
            existing = self.existing_steps()
            self._last_saved = existing[-1] if existing else None
        if multihost.process_index() == 0:
            self._write(step, state, modules, extra)
        # the primary's files (and its retention) are in place on return
        multihost.barrier()
        self._last_saved = step
        return True

    def _write(self, step: int, state: dict, modules: Optional[dict],
               extra: Optional[dict]) -> None:
        path = self._path(step)
        os.makedirs(os.path.join(path, "modules"), exist_ok=True)
        if extra is not None:
            _write_json(os.path.join(path, "extra.json"), extra)
        for name, module_state in (modules or {}).items():
            _write_atomic(os.path.join(path, "modules", f"{name}.pt"),
                          lambda tmp, s=module_state: torch.save(s, tmp))
        if modules and self.module_configs:
            _write_json(os.path.join(path, "modules_config.json"),
                        self.module_configs, indent=1)
        _write_atomic(os.path.join(path, "state.pt"),
                      lambda tmp: torch.save(state, tmp))
        # the new checkpoint is complete: retention may drop the previous
        prev = self._last_saved
        if prev is not None and prev != step and not self.is_milestone(prev):
            shutil.rmtree(self._path(prev), ignore_errors=True)

    def restore(self, step: int, map_location=None) -> dict:
        return torch.load(os.path.join(self._path(step), "state.pt"),
                          map_location=map_location, weights_only=True)

    def restore_latest(self, map_location=None):
        """(step, state) of the newest complete checkpoint, or None; across
        processes the one rank 0 finds, loaded onto `map_location` by every
        rank."""
        step = multihost.broadcast_object(self.latest_step())
        if step is None:
            return None
        return step, self.restore(step, map_location)

    def restore_extra(self, step: int) -> Optional[dict]:
        """Host-side sidecar saved with `extra=` (None if absent)."""
        path = os.path.join(self._path(step), "extra.json")
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore_module(self, step: int, name: str, map_location=None) -> dict:
        return torch.load(
            os.path.join(self._path(step), "modules", f"{name}.pt"),
            map_location=map_location, weights_only=True)

    def close(self) -> None:
        """Make every save durable (asva_tpu's `close` waits for its
        asynchronous writes).  Saves here are synchronous: each file was
        written and renamed before `save` returned."""

    def modules_dir(self, step: int) -> str:
        """The `checkpoint_modules_dir` to hand to load_animation_pipeline."""
        return os.path.join(self._path(step), "modules")
