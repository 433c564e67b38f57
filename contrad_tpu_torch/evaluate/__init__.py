"""Evaluation of a trained run (the port of ``contrad_tpu/evaluate``):
classifier metrics for the linear probe; FID (``fid``, ``sharded``), the
InceptionV3 (``inception``) and IS (``inception_score``); the evaluation
state across a resume (``persist``); image grids, the progress GIF and
PNGs (``visual``)."""
