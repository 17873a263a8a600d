from .defaults import DATASETS, ConcatDataset, DefaultDataset, build_dataset
from .transforms import TRANSFORMS, Compose
from .collate import collate_padded
from .loader import Loader, MultiDatasetLoader
from . import gs_datasets  # noqa: F401 (registers the GS datasets)

__all__ = ["DATASETS", "ConcatDataset", "DefaultDataset", "build_dataset", "TRANSFORMS",
           "Compose", "collate_padded", "Loader", "MultiDatasetLoader"]
