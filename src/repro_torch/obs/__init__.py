from repro_torch.obs.trace import NULL_OBS, NullObs

__all__ = ["NULL_OBS", "NullObs"]
