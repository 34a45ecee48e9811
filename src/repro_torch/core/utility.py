"""System utility U(T, A) (paper Eq. 9); a copy of ``repro.core.utility``."""
from __future__ import annotations


def utility(delay: float, accuracy_normalized: float, a: float) -> float:
    """U = a*T - (1-a) * (A - A_min)/(A_max - A_min).  Lower is better."""
    return a * delay - (1.0 - a) * accuracy_normalized
