from .roofline import (CollectiveOp, CountedStep, RooflineReport,
                       active_params, analyze_compiled, count_step,
                       model_flops)

__all__ = ["CollectiveOp", "CountedStep", "RooflineReport", "active_params",
           "analyze_compiled", "count_step", "model_flops"]
