"""Run directories, checkpoints and loading a run back (the port of
``contrad_tpu/utils``)."""
