from .cg import cg  # noqa: F401
from .cgmres import cgmres, cgmres_p  # noqa: F401
from .gmres import gmres  # noqa: F401
from .kkt import constrained_lsq  # noqa: F401
