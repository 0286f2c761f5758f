from .dataset import DatasetBaseclass, OnlineDataset, OfflineDataset
from .builders import (build_regression_dataset,
                       build_classification_dataset,
                       build_offline_np_dataset,
                       build_online_dataset)
