from .base import (  # noqa: F401
    IdentityPreconditioner,
    apply_preconditioner,
    as_preconditioner,
)
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
from .amg import AMG, amg  # noqa: F401
from .ilu_oracle import DenseApply, direct_oracle, ilu_oracle  # noqa: F401
