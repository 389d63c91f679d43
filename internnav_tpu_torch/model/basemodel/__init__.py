"""Base models of the port."""
