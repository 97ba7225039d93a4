# Checkpoints of the port (counterpart of repro.ckpt): the manifest, the
# atomic _COMMITTED rename and the background writer.
from repro_torch.ckpt.checkpoint import CheckpointManager, latest_step, load_flat, restore_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "latest_step", "load_flat", "restore_checkpoint", "save_checkpoint"]
