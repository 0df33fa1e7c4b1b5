"""Checkpoints of tensor trees (port of ``repro/checkpoint``)."""
