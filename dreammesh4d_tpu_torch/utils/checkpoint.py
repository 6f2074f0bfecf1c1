"""Checkpoints of the port's train state (counterpart of
``dreammesh4d_tpu/utils/checkpoint.py``, which writes orbax directories).

Layout: ``<trial>/ckpts/step_XXXXXXXX/`` holding one ``torch.save`` file,
``state.pt``: a dict of tensors, numbers and nested dicts/lists — the whole
train state, the optimizer's moments included.  ``"LAST"`` in the last path
component resolves to the newest step of its directory, and
``load_filtered`` takes one entry of a saved state (``system.weights``,
the cross-stage weight transfer).

A directory that the JAX package wrote (orbax) is recognised and refused
with an error that says so: the port does not read orbax checkpoints.
Under more than one device rank 0 writes and every rank waits for it;
every rank restores.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

from ..parallel import mesh as _mesh

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> str:
    """Write ``state`` to ``<ckpt_dir>/step_<step:08d>/state.pt`` (on rank
    0, the other ranks wait); returns the step directory."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))
    if _mesh.is_main_process():
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
    _mesh.barrier()
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``step_*`` directory of ``ckpt_dir`` with the highest step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m:
            steps.append((int(m.group(1)), os.path.join(ckpt_dir, d)))
    return max(steps)[1] if steps else None


def find_last_path(path: str) -> str:
    """Resolve a ``LAST`` placeholder in the last component of ``path`` to
    the newest checkpoint of its directory."""
    if path and "LAST" in os.path.basename(path):
        parent = os.path.dirname(path)
        last = latest_checkpoint(parent)
        if last is None:
            raise FileNotFoundError(f"No checkpoints under {parent}")
        return last
    return path


def step_from_path(path: str) -> int:
    m = re.search(r"step_(\d+)", path)
    return int(m.group(1)) if m else 0


def restore_checkpoint(path: str, map_location=None) -> dict:
    """The state saved at ``path`` (a step directory or ``.../LAST``), its
    tensors placed by ``map_location`` (e.g. the experiment's device)."""
    path = find_last_path(str(path))
    file = os.path.join(path, STATE_FILE)
    if not os.path.exists(file):
        if os.path.isdir(path) and any(n.startswith(("_CHECKPOINT_METADATA", "_METADATA",
                                                     "manifest.ocdbt")) for n in os.listdir(path)):
            raise ValueError(f"{path} is an orbax checkpoint of the JAX package (dreammesh4d_tpu); "
                             "the PyTorch port reads only the checkpoints it writes itself")
        raise FileNotFoundError(f"no checkpoint at {path} (expected {file})")
    return torch.load(file, map_location=map_location, weights_only=True)


def load_filtered(path: str, module_prefix: Optional[str] = None, map_location=None) -> Any:
    """The saved state, or only its entry ``module_prefix``."""
    state = restore_checkpoint(path, map_location)
    return state if module_prefix is None else state[module_prefix]
