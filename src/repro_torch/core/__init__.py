"""Graph container, csr engine and the two-phase peeling core."""
