from repro_torch.checkpoint.io import (read_manifest, restore_into,
                                       restore_tree, save_tree)
