"""Host-side data pipeline of the port (numpy): the trajectory store, the
episode dataset and the InternVLA-N1 SFT samples, packing and collate."""
