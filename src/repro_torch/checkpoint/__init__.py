"""Checkpoints in one ``.npz`` under the reference's key paths (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.npz import (  # noqa: F401
    restore,
    restore_group,
    restore_sliced,
    restore_step,
    restore_train,
    save,
    save_group,
    save_sliced,
    save_train,
    save_train_sliced,
)
