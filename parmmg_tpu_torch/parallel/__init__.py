"""Group decomposition and the distributed pass (port of ``parallel/``)."""
