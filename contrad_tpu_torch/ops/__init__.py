"""Ops of the port: the hand-written blur kernel (:mod:`.blur`) and the
plain PyTorch ops around it."""
