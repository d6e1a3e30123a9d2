"""The port's experiment layer (the JAX package's `repro.exp`). Only the
artifact store is ported so far; the sweep grid, the sweep runner and the
analysis come with the streaming slice."""
from repro_torch.exp.artifacts import (artifact_dir, list_artifacts,
                                       load_artifact, save_artifact,
                                       schema_tag)

__all__ = ["artifact_dir", "list_artifacts", "load_artifact",
           "save_artifact", "schema_tag"]
