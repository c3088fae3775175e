"""Model problems of the port: lkdv (1-D linear KdV), lkdvrk (the same
with Gauss–Legendre Runge–Kutta stage systems), swe (2-D linear rotating
shallow water) and heat (2-D heat equation)."""

from . import fem1d, fem2d, fixtures, heat, lkdv, lkdvrk, swe, tableaux  # noqa: F401
