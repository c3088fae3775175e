from .base import as_preconditioner  # noqa: F401
from .chebyshev import (  # noqa: F401
    Chebyshev,
    Neumann,
    chebyshev,
    neumann,
    power_bounds,
)
from .jacobi import Jacobi, diagonal, jacobi  # noqa: F401
