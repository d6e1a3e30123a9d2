from repro_torch.obs.trace import NULL_OBS, NullObs, ProgressLogger, log_line

__all__ = ["NULL_OBS", "NullObs", "ProgressLogger", "log_line"]
