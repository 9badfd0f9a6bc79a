"""The whole step's share of the card's float32 peak, in % (shares.py)."""
from benchmark.shares import mfu as read  # noqa: F401
