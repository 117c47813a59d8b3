"""Flow-matching paths and training losses."""
from .paths import GVPPath, LinearPath, VPPath, expand_t, get_path
from .transport import Transport, check_interval, create_transport, mean_flat

__all__ = ["GVPPath", "LinearPath", "VPPath", "expand_t", "get_path", "Transport",
           "check_interval", "create_transport", "mean_flat"]
