"""Roofline bounds of the port on NVIDIA H100s: the card's published peaks
(``constants``), the analytic per-stage FLOP and byte counts of a serve and
the whole-program three-term report of the dry run (``analysis``), the
collective traffic of a sharded program (``collectives``) and the analytic
sLSTM yardstick (``corrections``)."""
