"""Fleet surfaces of the port: the shared second cache tier
(:mod:`.tier`, ``cache_l2_dir``), the consistent-hash ring (:mod:`.ring`),
the router over serve daemons (:mod:`.router`, ``python -m
video_features_torch fleet``), its Prometheus aggregation
(:mod:`.aggregate`), the health table (:mod:`.status`) and the shared
tier of the executable store (:mod:`.artifacts`, ``aot_l2_dir``). No
module here imports torch.
"""
from video_features_torch.fleet.ring import HashRing

__all__ = ['HashRing']
