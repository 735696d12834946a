"""The S5P pipeline of the port: Alg. 1 clustering, the CMS Θ sketch, the
Alg. 2 Stackelberg game, Alg. 3 placement, metrics and the driver."""

from .s5p import S5PConfig, S5POutput, cluster_statistics, s5p_partition  # noqa: F401
