"""Training of the port: the optimizer chain, the single-device trainer,
the InternVLA-N1 trainer and its command line (`train_n1`)."""
