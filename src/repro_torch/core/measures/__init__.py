"""The paper's nonconformity measures: k-NN and simplified k-NN
(``knn``), KDE (``kde``), LS-SVM (``lssvm``) and bootstrap
(``bootstrap``, Algorithm 3), each with its standard and its
incremental&decremental path."""
from repro_torch.core.measures import bootstrap  # noqa: F401
