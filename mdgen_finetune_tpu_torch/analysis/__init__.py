"""What the task CLIs need of the analysis stack: torsion features, TICA,
k-means and Markov state models for the MSM metadata (``cli/msm_common.py``)
and the design task's ``sequence_recovery`` (``cli/analyze_design.py``).
The other metrics and the analysis pipelines are not ported yet (ROADMAP.md
queue 1 item 10)."""
from .cluster import KMeans
from .featurize import feature_labels, featurize_trajectory
from .msm import MarkovStateModel, pcca_plus
from .task_metrics import sequence_recovery
from .tica import TICA

__all__ = ["featurize_trajectory", "feature_labels", "TICA", "KMeans", "MarkovStateModel",
           "pcca_plus", "sequence_recovery"]
