"""device_idle_share: the device (the H100), in %: 1 - the union of the
kernels' intervals over the wall time, from torch.profiler over the traffic
mix's profiled rounds."""


def read(trace):
    prof = trace.get("profile") or {}
    if not prof.get("window_s") or not prof.get("busy_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
