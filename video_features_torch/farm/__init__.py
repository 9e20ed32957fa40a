"""The decode farm: decode worker processes feeding the packed loop.

On the card's host the packed loop's decode and host resize run on one
producer thread, and the card waits for them: the GIL and one process's
swscale cap it, and threads of the per-frame transform buy little. With
``decode_workers > 1`` and ``pack_across_videos=true``, N worker
processes (``farm/worker.py``) each replay the family's decode and host
transform (``io/video.py``, ``ops/host_transforms.py``) from a picklable
recipe (``farm/recipes.py``) and ship the windows through their own
bounded shared-memory ring (``farm/ring.py``, in ``/dev/shm``), so pixels
never take the pickle hop.

:class:`DecodeFarm` (``farm/farm.py``) is what ``parallel.packing.
run_packed`` and ``run_packed_fused`` use in place of the in-process
windower: the same ``(task, window, meta)`` items, ``FLUSH`` and
``NUDGE``, per-video fault isolation and ``task`` accounting, so the
outputs are the bytes of ``decode_workers=1`` at any worker count.

Nothing in this package imports torch: a spawned worker imports it, and
neither the import's cost nor a CUDA context belongs there.
"""
from video_features_torch.farm.farm import (  # noqa: F401
    RESPAWN_LIMIT, DecodeFarm, FarmUnavailable, farm_available,
    merge_farm_stats,
)
from video_features_torch.farm.recipes import (  # noqa: F401
    FramewiseRecipe, FusedRecipe, StackRecipe, resolve_transform,
)
