from repro_torch.checkpoint.store import (CheckpointStore,  # noqa: F401
                                          latest_step, load_checkpoint,
                                          save_checkpoint)
