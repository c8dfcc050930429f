"""Kernels of the inverted-residual blocks: as conv3x3_roofline, over the
whole blocks, whose compulsory bytes are the block's input, output and
weights (the expansion need not leave the chip)."""
from gpubench import counting

NAME, UNIT = "inverted_residual_roofline", "%"
LAYER = "kernels: separable_streamed, depthwise_strided_streamed, matmul"
MOVES = "images_per_s"


def read(rec):
    dev, peak = rec.get("layer_device_s"), rec.get("peak")
    rows = [r for r in rec["rows"] if r["op"] == "inverted_residual"]
    if not dev or not peak or not rows or any(r["name"] not in dev
                                              for r in rows):
        return None
    least = sum(counting.least_seconds(r, rec["batch"], peak)[0]
                for r in rows)
    return 100.0 * least / sum(dev[r["name"]] for r in rows)
