"""The device's idle share of the traced sub-window, in % (shares.py)."""
from benchmark.shares import idle as read  # noqa: F401
