"""Group decomposition of one device's mesh (port of ``parallel/``)."""
