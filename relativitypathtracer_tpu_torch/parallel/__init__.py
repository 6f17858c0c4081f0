"""Sharded rendering: the frame's 1024-ray blocks dealt over CUDA devices
(tiles.py)."""
