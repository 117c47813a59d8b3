"""Flow-matching paths, training losses, ODE / SDE samplers and the likelihood."""
from .paths import GVPPath, LinearPath, VPPath, expand_t, get_path
from .samplers import ode_likelihood, sample_ode, sample_sde
from .transport import Transport, check_interval, create_transport, mean_flat

__all__ = ["GVPPath", "LinearPath", "VPPath", "expand_t", "get_path", "Transport",
           "check_interval", "create_transport", "mean_flat", "ode_likelihood", "sample_ode",
           "sample_sde"]
