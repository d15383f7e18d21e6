"""``distributed`` of the port: activation recompute (``fleet``)."""
