"""kernels.roofline_pct: the whole step's share of the memory roofline in
the box cells, in % (yardstick.roofline_pct)."""

from lbm_bench.yardstick import roofline_pct as read  # noqa: F401
