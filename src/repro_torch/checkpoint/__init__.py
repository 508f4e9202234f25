from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step, load_state, save_state

__all__ = ["CheckpointManager", "latest_step", "load_state", "save_state"]
