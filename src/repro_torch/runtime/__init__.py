"""Runtime services of the port: fault detection, straggler mitigation,
elastic remesh (``fault.py``) and the Trainer (``trainer.py``)."""
from .fault import (FailureInjector, HeartbeatMonitor, NodeFailure,
                    StragglerMonitor, elastic_reshard, fail_device,
                    shrink_mesh_shape)
from .trainer import TrainConfig, Trainer, make_train_step

__all__ = ["FailureInjector", "HeartbeatMonitor", "NodeFailure",
           "StragglerMonitor",
           "elastic_reshard", "fail_device", "shrink_mesh_shape",
           "TrainConfig", "Trainer", "make_train_step"]
