"""Several processes over one video list: the shared-nothing worklist
contract (a copy of ``video_features_tpu/parallel/worklist.py``).

Every process runs the same command over the full list and takes a
deterministic interleaved shard of it, so N healthy processes do no
duplicate work, while a dead process's videos are picked up by any
worker re-run with the full list (the skip-if-exists check makes
re-processing free).
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence


def shard_worklist(paths: Sequence[str],
                   shard_id: Optional[int] = None,
                   num_shards: Optional[int] = None) -> List[str]:
    """This process's interleaved shard of the video list; defaults to the
    process group's rank and size (``parallel/distributed.py``)."""
    if num_shards is None or shard_id is None:
        from video_features_torch.parallel.distributed import (
            process_count, process_index,
        )
        if num_shards is None:
            num_shards = process_count()
        if shard_id is None:
            shard_id = process_index()
    if not 0 <= shard_id < num_shards:
        raise ValueError(f'shard_id {shard_id} out of range [0, {num_shards})')
    # round-robin keeps the shards balanced even when the list is sorted
    # by size or class, unlike contiguous blocks
    return list(paths[shard_id::num_shards])


def shuffled(paths: Sequence[str], seed: Optional[int] = None) -> List[str]:
    """A seeded shuffle of the list, for runs of unequal workers."""
    out = list(paths)
    random.Random(seed).shuffle(out)
    return out
