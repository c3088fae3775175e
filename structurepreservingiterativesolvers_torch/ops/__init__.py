from .sparse import DIA, dia_from_scipy, dia_spmm, dia_spmv, from_scipy, to_scipy  # noqa: F401
from .stencil import Stencil, as_dia, maybe_stencil  # noqa: F401
