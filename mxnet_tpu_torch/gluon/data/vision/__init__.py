from . import transforms
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageFolderDataset, ImageRecordDataset,
                       ImageListDataset)
