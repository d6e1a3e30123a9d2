"""Paper-faithful GenFV experiment config (Section VI): ResNet-18-style CNN
on 32x32 class-conditional image datasets with Dirichlet non-IID partitions.
"""
from dataclasses import dataclass

from repro_torch.configs.base import GenFVConfig


@dataclass(frozen=True)
class CNNConfig:
    name: str
    num_classes: int
    image_size: int = 32
    channels: int = 3
    # ResNet-18 stage widths (paper uses ResNet-18; we keep the same topology,
    # width-scalable for smoke tests).
    stem_width: int = 64
    stage_blocks: tuple = (2, 2, 2, 2)
    width_mult: float = 1.0


DATASETS = {
    # name -> (num_classes, train_size, test_size) mirroring the paper's three
    "cifar10": (10, 50_000, 10_000),
    "cifar100": (100, 50_000, 10_000),
    "gtsrb": (43, 39_209, 12_630),
}


def cnn_config(dataset: str = "cifar10", width_mult: float = 1.0) -> CNNConfig:
    classes, _, _ = DATASETS[dataset]
    return CNNConfig(name=f"resnet18-{dataset}", num_classes=classes,
                     width_mult=width_mult)


# Table I: \hat{EMD} thresholds per dataset and Dirichlet alpha.
EMD_THRESHOLDS = {
    "cifar10": {0.1: 1.5, 0.3: 1.2, 0.5: 1.0, 1.0: 0.8},
    "cifar100": {0.1: 1.5, 0.3: 1.2, 0.5: 1.0, 1.0: 0.8},
    "gtsrb": {0.1: 1.5, 0.3: 1.3, 0.5: 1.2, 1.0: 1.0},
}


def genfv_config(dataset: str = "cifar10", alpha: float = 0.1,
                 **overrides) -> GenFVConfig:
    defaults = dict(dirichlet_alpha=alpha,
                    emd_threshold=EMD_THRESHOLDS[dataset][alpha])
    defaults.update(overrides)
    return GenFVConfig(**defaults)
