"""Entry points of the port (evaluation; training comes later)."""
