from repro_torch.data.synthetic import make_image_dataset, DATASET_CLASSES
from repro_torch.data.partition import dirichlet_partition
