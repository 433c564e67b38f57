"""Evaluation of a trained run (the port of ``contrad_tpu/evaluate``):
classifier metrics for the linear probe, and image grids and PNGs."""
