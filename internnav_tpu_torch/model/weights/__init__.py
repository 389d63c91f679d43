"""Weight conversion into the port's modules."""
