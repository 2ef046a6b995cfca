"""Runtime services of the port: fault detection, straggler mitigation,
elastic remesh (``fault.py``).  The reference's trainer
(``repro/runtime/trainer.py``) comes with the training slice."""
from .fault import (FailureInjector, HeartbeatMonitor, NodeFailure,
                    StragglerMonitor, elastic_reshard, fail_device,
                    shrink_mesh_shape)

__all__ = ["FailureInjector", "HeartbeatMonitor", "NodeFailure",
           "StragglerMonitor",
           "elastic_reshard", "fail_device", "shrink_mesh_shape"]
