from .config import TetrahedraNerfConfig, check_supported, tetranerf_preset
from .tetra_nerf import TetraNerf

__all__ = ["TetraNerf", "TetrahedraNerfConfig", "check_supported", "tetranerf_preset"]
