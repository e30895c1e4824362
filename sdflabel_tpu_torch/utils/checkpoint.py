"""Save and resume a full train state in PyTorch's own format.

Counterpart of sdflabel_tpu/utils/checkpoint.py (orbax there). The CSS
state (model parameters and BatchNorm statistics, Adam's moments and step
count, the train step count) and the DeepSDF state (any tree of tensors,
:func:`save_tree`) go into ``<ckpt_dir>/step_<n:08d>.pt``, written to a
temporary file and renamed, so a cut run leaves no half checkpoint under
a checkpoint's name. A run resumed from it continues bit-identically on
the same device (the data stream depends only on seed, epoch and index).
"""

from __future__ import annotations

import os
import re

import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def save_train_state(ckpt_dir: str, state, step: int | None = None) -> str:
    """Write `state` (engine/css_train.py::TrainState) as step `step`
    (default: its own step count); returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    step = state.step if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "opt": state.opt.state_dict(), "step": state.step}, tmp)
    os.replace(tmp, path)
    return path


def save_tree(ckpt_dir: str, tree, step: int) -> str:
    """Write a tree (dicts, lists, tuples) of tensors and numbers as step
    `step`; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def load_tree(path: str, device) -> dict:
    """A tree written by :func:`save_tree`, its tensors on `device`."""
    return torch.load(path, map_location=device, weights_only=True)


def restore_train_state(path: str, state):
    """Load a checkpoint into `state` in place (tensors land on the
    model's device); returns it."""
    dev = next(state.model.parameters()).device
    saved = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.opt.load_state_dict(saved["opt"])
    state.step = int(saved["step"])
    return state


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The checkpoint of the highest step in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted((int(m.group(1)), name) for name in os.listdir(ckpt_dir)
                   if (m := _STEP_FILE.fullmatch(name)))
    return os.path.join(ckpt_dir, steps[-1][1]) if steps else None


def checkpoint_step(path: str) -> int:
    """The step number in a checkpoint's file name."""
    return int(_STEP_FILE.fullmatch(os.path.basename(path)).group(1))
