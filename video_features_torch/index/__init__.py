"""Feature index: sharded exact nearest-neighbor search over every
extracted embedding (the port's copy of ``video_features_tpu/index/``).

The cache (``cache/``) makes extraction idempotent; the index makes it
*searchable*. An ingest worker tails the cache's append-only manifest
and folds every published frame-wise feature object into per-(family,
dim) embedding shards (:mod:`.shards`: bounded, atomically rewritten,
delete-on-evict coherent with cache GC through the store's
``on_evict``). Queries run the exact top-k of :mod:`.search` on the
service's device. :mod:`.service` is the serving surface behind the
loopback ``search`` and ``index_status`` commands and ``POST
/v1/search``; :mod:`.cli` is ``python -m video_features_torch index``
and :mod:`.gc` the offline maintenance tool. Only :mod:`.search`'s
query functions import torch.
"""
from video_features_torch.index.shards import IndexStore  # noqa: F401
