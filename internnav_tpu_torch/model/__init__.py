"""Model ports: the InternVLA-N1 dual system and its encoders."""
