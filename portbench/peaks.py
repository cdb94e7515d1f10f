"""Published peaks of the card, looked up by ``torch.cuda.
get_device_name()``: NVIDIA's H100 datasheet, dense rates (the table of
``tools/mfu.py``). f32 is the CUDA cores' rate: the system computes in
float32 with TF32 off. A card not in the table has no peak, and the
metrics that divide by one are left out."""

from __future__ import annotations

# name substring (lower case), the more specific first:
# (f32 FLOP/s, HBM bytes/s)
PEAKS = {
    "h100 pcie": (51.2e12, 2000e9),
    "h100 80gb hbm3": (66.9e12, 3350e9),
    "h100 sxm": (66.9e12, 3350e9),
}


def of(kind: str):
    """(f32 FLOP/s, bytes/s) of the card named `kind`, or None."""
    k = kind.lower()
    for sub, peaks in PEAKS.items():
        if sub in k:
            return peaks
    return None
