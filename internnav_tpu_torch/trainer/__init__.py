"""Training of the port: the optimizer chain, the mesh-parallel trainer
with grad accumulation and the parameter EMA (`ema`), the InternVLA-N1
trainer and its command line (`train_n1`)."""
