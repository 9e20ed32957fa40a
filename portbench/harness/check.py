"""The comparison that decides ``correct``: what the timed path delivered,
at the timed sizes, against the plain reference run on the same files
and weights with TF32 off, by the configuration's reference module
(``portbench/reference/<reference>.py``). Each number compared is
printed beside its limit (``portbench/limits/<cell>.json``)."""
from __future__ import annotations

from typing import Callable, Dict, List


def pick_videos(done: List[tuple], rng, n: int, key: Callable) -> list:
    """Up to ``n`` completions of distinct videos, drawn from ``rng``."""
    picked, seen = [], set()
    for i in rng.permutation(len(done)):
        k = key(done[i])
        if k not in seen:
            seen.add(k)
            picked.append(done[i][1])
        if len(picked) == n:
            break
    return picked


def pick_positions(order: List[int], first: int, n: int, rng) -> List[int]:
    """Up to ``n`` positions among the first ``first`` of ``order``, of
    distinct videos, drawn from ``rng``."""
    picked, seen = [], set()
    for pos in rng.permutation(min(first, len(order))):
        if order[pos] not in seen:
            seen.add(order[pos])
            picked.append(int(pos))
        if len(picked) == n:
            break
    return picked


def compare(cell, sample: list, weights, device) -> Dict[str, dict]:
    """{number: {"value", "limit"}} in the limits file's order."""
    values = cell.family.compare(cell, sample, weights, device)
    return {name: {'value': values[name], 'limit': float(spec['limit'])}
            for name, spec in cell.limits.items()}
