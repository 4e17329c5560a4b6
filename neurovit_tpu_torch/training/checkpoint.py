"""Loading weights into a port model.

Counterpart of ``load_variables_file`` in
``neurovit_tpu/training/checkpoint.py:116``: the reference's inference
load (main.py:166-170), ``strict=False`` by default.
"""

from __future__ import annotations

from torch import nn as tnn

from neurovit_tpu_torch.training import state_dict as sd


def load_checkpoint(model: tnn.Module, path: str, strict: bool = False):
    """Load the state-dict file at ``path`` into ``model`` in place.
    ``strict=False`` skips missing and unknown keys; a shape mismatch
    raises either way. Returns torch's (missing_keys, unexpected_keys)."""
    return model.load_state_dict(sd.load(path), strict=strict)
