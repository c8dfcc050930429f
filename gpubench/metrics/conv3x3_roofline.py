"""Kernels of the dense 3x3 stride-1 convs: the sum over those layers of
the least time (counting.least_seconds: direct FLOPs over the TF32 peak or
compulsory bytes over HBM bandwidth) over the sum of the device time the
trace attributes to them (hooked calls: kernels whose midpoint lies
inside the layer's synchronized host interval; devtrace.attribute)."""
from gpubench import counting

NAME, UNIT = "conv3x3_roofline", "%"
LAYER = "kernels: winograd_streamed and the plans around it"
MOVES = "images_per_s"


def read(rec):
    dev, peak = rec.get("layer_device_s"), rec.get("peak")
    rows = [r for r in rec["rows"] if r["op"] == "conv" and r["k"] == 3
            and r["stride"] == 1]
    if not dev or not peak or not rows or any(r["name"] not in dev
                                              for r in rows):
        return None
    least = sum(counting.least_seconds(r, rec["batch"], peak)[0]
                for r in rows)
    return 100.0 * least / sum(dev[r["name"]] for r in rows)
