"""The peaks of one NVIDIA H100 SXM (80 GB HBM3) that the rooflines take.

Bandwidth: 3.35 TB/s, NVIDIA's data sheet. Field multiplies: derived from
the architecture, not published: a 64 x 64 -> 128-bit product takes at
least four 32-bit multiply-adds (IMAD), and the card issues 64 of them per
SM per clock on 132 SMs at the 1980 MHz maximum SM clock. Both peaks assume
the card's full power limit of 700 W.
"""

HBM_BYTES_PER_S = 3.35e12
SMS = 132
IMAD_PER_SM_CLOCK = 64
MAX_SM_CLOCK_HZ = 1.98e9
IMAD_PER_FIELD_MUL = 4
FIELD_MULS_PER_S = SMS * IMAD_PER_SM_CLOCK * MAX_SM_CLOCK_HZ / \
    IMAD_PER_FIELD_MUL


def least_seconds(nbytes: float, field_muls: float) -> tuple[float, str]:
    """The least time the card could take, and which peak bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = field_muls / FIELD_MULS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
