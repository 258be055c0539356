"""Models layer (reference: models/ — SpatialKNN + transformer core)."""

from .checkpoint import CheckpointManager
from .core import BinaryTransformer, IterationState, IterativeTransformer
from .knn import (FusedKNNIndex, SpatialKNN, build_knn_indexes,
                  knn_host_truth, knn_index_from_arrays)

__all__ = ["BinaryTransformer", "CheckpointManager", "FusedKNNIndex",
           "IterationState", "IterativeTransformer", "SpatialKNN",
           "build_knn_indexes", "knn_host_truth", "knn_index_from_arrays"]
