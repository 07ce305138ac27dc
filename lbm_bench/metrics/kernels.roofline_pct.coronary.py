"""kernels.roofline_pct.coronary: the whole step's share of the memory
roofline in the coronary cells, in % (yardstick.roofline_pct)."""

from lbm_bench.yardstick import roofline_pct as read  # noqa: F401
