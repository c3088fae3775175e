from .general import GeneralConstraint, taylor_buffers, true_value  # noqa: F401
from .quadratic import (  # noqa: F401
    MatComb,
    QuadraticConstraint,
    ReducedBuffers,
    StageKron,
    constraint_checker,
    stage_mapped,
)
