from .quadratic import (  # noqa: F401
    MatComb,
    QuadraticConstraint,
    ReducedBuffers,
    constraint_checker,
)
