"""Tools: reference-checkpoint import, the parity fixtures and the
matched-epoch parity report, a train step's FLOPs and bytes against the
card's peaks (`mfu`), the CenterRefine jitter head's recovery of the
injected error (`jitter_diag`) and GroupFree3D's subset-FPS sweep
(`gf_sweep`)."""
