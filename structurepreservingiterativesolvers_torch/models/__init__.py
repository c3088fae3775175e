"""Model problems of the port: lkdv (1-D linear KdV) and swe (2-D linear
rotating shallow water)."""
