from anovos_tpu_torch.drift_stability.drift_detector import statistics
from anovos_tpu_torch.drift_stability.stability import (
    feature_stability_estimation,
    stability_index_computation,
)

__all__ = ["feature_stability_estimation", "stability_index_computation", "statistics"]
