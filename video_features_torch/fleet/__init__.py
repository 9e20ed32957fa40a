"""Fleet surfaces of the port: the shared second cache tier
(:mod:`.tier`, ``cache_l2_dir``), the consistent-hash ring (:mod:`.ring`),
the router over serve daemons (:mod:`.router`, ``python -m
video_features_torch fleet``), its Prometheus aggregation
(:mod:`.aggregate`) and the health table (:mod:`.status`). No module
here imports torch. The JAX package's AOT artifact tier
(``fleet/artifacts.py``) waits for an executable store in the port.
"""
from video_features_torch.fleet.ring import HashRing

__all__ = ['HashRing']
