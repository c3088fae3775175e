from .base import as_preconditioner  # noqa: F401
from .chebyshev import (  # noqa: F401
    Chebyshev,
    Neumann,
    SkewNormalChebyshev,
    chebyshev,
    neumann,
    power_bounds,
    skew_normal_chebyshev,
)
from .jacobi import Jacobi, diagonal, jacobi  # noqa: F401
