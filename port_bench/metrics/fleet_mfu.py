"""fleet_mfu: the fleet step's model FLOPs over its span, as a share of
the device's float32 peak, in %: useful local-SGD images (padding
excluded) x the forward-and-backward FLOPs of one image, over the summed
round/aggregate time."""
from port_bench.metrics._spans import timed_rounds


def read(trace):
    rounds = [r for r in timed_rounds(trace) if "round/aggregate" in r["ms"]]
    seconds = sum(r["ms"]["round/aggregate"] for r in rounds) / 1e3
    images = sum(r["fleet_images"] for r in rounds)
    if not trace["peak_flops"] or seconds <= 0 or images == 0:
        return None
    return 100.0 * images * trace["flops"]["train"] / seconds / trace["peak_flops"]
