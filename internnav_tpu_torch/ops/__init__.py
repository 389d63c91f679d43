"""Torch ops: attention (plain versions + the Hopper flash kernel), rotary
embeddings and the flow-matching scheduler."""
