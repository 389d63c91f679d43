"""InternVLA-N1 dual-system model, policy and their building blocks."""
