from repro_torch.checkpoint.checkpointer import (Placement, restore_checkpoint,  # noqa: F401
                                                 save_checkpoint)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
