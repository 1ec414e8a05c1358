"""Counts of a step's work and their roofline: :mod:`.opcount` (FLOPs,
bytes, collectives and memory of a step run on ``meta`` tensors or the
card) and :mod:`.roofline` (the terms at the H100's data-sheet rates)."""
