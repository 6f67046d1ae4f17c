"""Published peak of the card the benchmark runs on.

NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet, at the full 700 W power
limit.  A roofline share is stated against it, with the card's power
limit beside it.
"""

HBM_BYTES_PER_S = 3.35e12
