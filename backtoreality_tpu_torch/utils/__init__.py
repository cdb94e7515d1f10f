"""Host-side point-cloud helpers (numpy)."""
