"""round_mfu: the whole round's model FLOPs (useful fleet SGD, omega_a's
SGD, the evaluation's forward passes, the generator's denoising steps)
over the rounds' wall time, as a share of the device's float32 peak, in
%."""
from port_bench.metrics._spans import timed_rounds


def read(trace):
    rounds = timed_rounds(trace)
    seconds = sum(r["wall_ms"] for r in rounds) / 1e3
    if not trace["peak_flops"] or seconds <= 0:
        return None
    f = trace["flops"]
    work = sum((r["fleet_images"] + r["aug_images"]) * f["train"]
               + r["eval_images"] * f["forward"] + r["gen_flops"] for r in rounds)
    return 100.0 * work / seconds / trace["peak_flops"]
