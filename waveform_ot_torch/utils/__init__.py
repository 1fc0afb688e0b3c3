"""Utilities: named-array bundles and checkpoints, profiling and timing."""

from waveform_ot_torch.utils.io import (  # noqa: F401
    read_json, read_pickle, restore_checkpoint, save_checkpoint, write_json,
    write_pickle,
)
from waveform_ot_torch.utils.profiling import (  # noqa: F401
    StageTimer, benchmark, top_device_ops,
)
