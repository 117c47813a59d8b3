"""What the task CLIs' MSM metadata needs of the analysis stack
(``cli/msm_common.py``): torsion features, TICA, k-means and Markov state
models. The metrics and the analysis pipelines are not ported yet
(ROADMAP.md queue 1 item 10)."""
from .cluster import KMeans
from .featurize import feature_labels, featurize_trajectory
from .msm import MarkovStateModel, pcca_plus
from .tica import TICA

__all__ = ["featurize_trajectory", "feature_labels", "TICA", "KMeans", "MarkovStateModel",
           "pcca_plus"]
