from repro_torch.ckpt.checkpoint import (CheckpointManager, array_digest,
                                         latest_step, load_npz,
                                         restore_checkpoint, save_checkpoint,
                                         save_npz)
