"""Flow-matching paths, training losses and ODE samplers."""
from .paths import GVPPath, LinearPath, VPPath, expand_t, get_path
from .samplers import sample_ode
from .transport import Transport, check_interval, create_transport, mean_flat

__all__ = ["GVPPath", "LinearPath", "VPPath", "expand_t", "get_path", "Transport",
           "check_interval", "create_transport", "mean_flat", "sample_ode"]
