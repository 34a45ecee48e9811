"""Roofline bounds of the port on one NVIDIA H100: the card's published
peaks (``constants``) and the analytic per-stage FLOP and byte counts of a
serve (``analysis``)."""
