"""Checkpointing with the reference's cadence (port of
``voicepuppet_tpu/train/checkpoint.py``).

tf.train.Saver semantics (train_bfmnet.py:73-77, 94-96, 141-145): the
trainers' ``fit`` loops save at exact multiples of ``save_interval``
(interval crossings when a call runs several steps) and never at step 0;
the manager keeps the last ``max_to_keep``, restores the latest if one
exists and otherwise returns the state unchanged.  A checkpoint is ``ckpt_<step>.pt``, a ``torch.save``
of the state's ``state_dict()``: step, module state_dicts (parameters and
BN buffers) and optimizer states.  The JAX package's orbax directories
are a different format; they reach the port only as npz files
(``tools/convert_assets.py`` there).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10,
                 save_interval: int = 5000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any):
        """Write ``ckpt_<step>.pt`` (through a temporary name, so a crash
        leaves no partial file under a checkpoint's name) and drop all but
        the newest ``max_to_keep``."""
        tmp = self.path(step) + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def load(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The saved dict at ``step`` (default: the latest), on the CPU, or
        None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load the checkpoint at ``step`` (default: the latest) into
        ``state`` and return it; with no checkpoint, return ``state``
        unchanged (ref: train_bfmnet.py:94-96)."""
        blob = self.load(step)
        if blob is None:
            return state
        state.load_state_dict(blob)
        return state
