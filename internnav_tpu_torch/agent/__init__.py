"""Agents of the port (the InternVLA-N1 dual-system agent)."""
