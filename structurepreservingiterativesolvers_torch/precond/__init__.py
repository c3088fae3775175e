from .base import apply_preconditioner, as_preconditioner  # noqa: F401
from .chebyshev import (  # noqa: F401
    Chebyshev,
    Neumann,
    NeumannComposite,
    SkewNormalChebyshev,
    chebyshev,
    neumann,
    neumann_composite,
    power_bounds,
    skew_normal_chebyshev,
)
from .jacobi import (  # noqa: F401
    RAS,
    BlockJacobi,
    Jacobi,
    block_jacobi,
    contiguous_blocks,
    diagonal,
    jacobi,
    ras,
)
