"""The paper's own experimental configuration (Appendix E), the port's
copy of ``repro/configs/paper.py``.

``launch.figures`` defaults to these hyperparameters over the paper's full
grid ``numpy.logspace(1, 5, 13)``. The paper ran it on a 48-thread Xeon
with 10 h / 48 h timeouts; on one card the runner's budget takes their
place: a path stops growing n once the last n's time, extrapolated by the
path's complexity, would pass 2 s a test point (60 s for a fit).
"""
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PaperConfig:
    # App. E hyperparameter table
    knn_k: int = 15                   # Euclidean distance, k = 15
    kde_bandwidth: float = 1.0        # Gaussian kernel, h = 1
    lssvm_kernel: str = "linear"      # linear kernel
    lssvm_rho: float = 1.0            # rho = 1
    bootstrap_B: int = 10             # Random Forest, B = 10 trees
    tree_depth: int = 10              # depth <= 10, sqrt(p) features/split
    # §7.1 setup
    n_features: int = 30              # make_classification(30 features)
    n_test: int = 100                 # 100 test points per size
    n_seeds: int = 5                  # 5 initialization seeds
    icp_train_frac: float = 0.5      # t/n = 0.5
    # App. G (MNIST): 784 features, 10 labels, 60k/10k split
    mnist_features: int = 784
    mnist_labels: int = 10

    def paper_n_grid(self) -> np.ndarray:
        """The paper's exact grid: numpy.logspace(1, 5, 13) (footnote 3)."""
        return np.logspace(1, 5, 13, dtype="int")


CONFIG = PaperConfig()
