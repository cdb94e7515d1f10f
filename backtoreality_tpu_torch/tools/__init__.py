"""Tools: reference-checkpoint import, the parity fixtures and the
matched-epoch parity report."""
