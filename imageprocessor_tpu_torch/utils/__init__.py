"""Process metrics for the port (a copy of the reference's, see metrics.py)."""
