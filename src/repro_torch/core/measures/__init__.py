"""The paper's nonconformity measures: k-NN and simplified k-NN
(``knn``), KDE (``kde``) and LS-SVM (``lssvm``), each with its standard
and its incremental&decremental path."""
