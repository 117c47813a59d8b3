"""The analysis stack (the JAX package's ``analysis/``), host numpy / scipy:
torsion features, TICA, k-means, Markov state models with PCCA+ and
transition-path sampling; the physics metrics (torsion and TICA JSDs,
decorrelation), the peptide-simulation pipeline ``analyze_sim``, and the
task metrics (transition-path ensembles and the replica sweep, upsampling
autocorrelation, design sequence recovery)."""
from .cluster import KMeans
from .featurize import feature_labels, featurize_trajectory
from .metrics import acovf, decorrelation, tica_jsd, torsion_jsd
from .msm import MarkovStateModel, get_state_probs, get_tp_likelihood, pcca_plus, sample_tp
from .pipeline import analyze_sim
from .task_metrics import (analyze_tps_ensemble, analyze_tps_replica_sweep, analyze_upsampling,
                           sequence_recovery)
from .tica import TICA

__all__ = [
    "featurize_trajectory",
    "feature_labels",
    "TICA",
    "KMeans",
    "MarkovStateModel",
    "pcca_plus",
    "sample_tp",
    "get_tp_likelihood",
    "get_state_probs",
    "acovf",
    "torsion_jsd",
    "decorrelation",
    "tica_jsd",
    "analyze_sim",
    "analyze_tps_ensemble",
    "analyze_tps_replica_sweep",
    "analyze_upsampling",
    "sequence_recovery",
]
