from .sparse import (  # noqa: F401
    BSR,
    DIA,
    ELL,
    bsr_from_scipy,
    bsr_spmm,
    bsr_spmv,
    dia_from_scipy,
    dia_spmm,
    dia_spmv,
    ell_from_scipy,
    ell_spmm,
    ell_spmv,
    from_scipy,
    spmm,
    spmv,
    to_scipy,
)
from .stencil import Stencil, as_dia, maybe_stencil  # noqa: F401
