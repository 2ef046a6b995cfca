from .store import (AsyncCheckpointer, latest_step, restore_checkpoint,
                    save_checkpoint, list_steps)

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint", "list_steps"]
