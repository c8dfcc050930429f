"""The whole forward: direct-convolution and dense FLOPs per image
(counting.py) times the traced window's images per second, over the card's
dense TF32 peak, on which the port's TF32x3 products run."""
from gpubench import counting

NAME, UNIT = "forward_mfu", "%"
LAYER = "whole forward: NetworkPlan.apply"
MOVES = "images_per_s"


def read(rec):
    if rec["kind"] != "offline" or not rec.get("peak"):
        return None
    flops = counting.forward_flops(rec["rows"]) * rec["images"]
    return 100.0 * flops / rec["window_s"] / rec["peak"]["tf32_flops"]
