"""The arithmetic the metric readers share. Each returns None where the
run has nothing to read (another cell's unit, an untraced run)."""
from __future__ import annotations

from typing import Optional


def rate(run, unit: str) -> Optional[float]:
    """Items of ``unit`` delivered over the window's seconds."""
    return run.items / run.window_s if run.unit == unit else None


def host_ms(run, unit: str) -> Optional[float]:
    """The program's ``decode+preprocess`` stage in the window, ms per
    item delivered in it."""
    if run.unit != unit or run.spans is None or not run.items:
        return None
    return 1e3 * run.spans.total('decode+preprocess', run.t_a, run.t_b) / run.items


def occupancy(run, unit: str) -> Optional[float]:
    """Valid batch slots over all slots of the steps, %."""
    slots = run.slots or {}
    if run.unit != unit or not slots.get('occ_capacity'):
        return None
    return 100.0 * slots['occ_valid'] / slots['occ_capacity']


def mfu(run, unit: str) -> Optional[float]:
    """Counted FLOPs of the items delivered in the window, over the
    window's seconds, as a share of the peak, %."""
    if run.unit != unit or not run.flops_per_item:
        return None
    return 100.0 * run.items * run.flops_per_item / run.window_s / run.peak_flops


def device_idle(run, unit: str) -> Optional[float]:
    """Share of the traced window with nothing running on the device, %."""
    dt = run.device_trace
    if run.unit != unit or dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)


def roofline(run, unit: str, name: str) -> Optional[float]:
    """Counted FLOPs of a benchmark range's calls over the device time of
    the kernels they launched, as a share of the peak, %."""
    dt = run.device_trace
    if run.unit != unit or dt is None:
        return None
    calls, seconds = dt.range_calls.get(name, 0), dt.range_s.get(name, 0.0)
    if not calls or seconds <= 0 or name not in run.range_flops:
        return None
    return 100.0 * calls * run.range_flops[name] / seconds / run.peak_flops

