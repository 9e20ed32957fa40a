"""The entries a cell's window drives, by the traffic mix's ``driver``:

  * ``packed_corpus``: ``BaseExtractor.extract_packed`` (the packed loop,
    ``run_packed``) over the corpus in seeded orders, each pass to a fresh
    output root, for the whole window; the item is a 16-frame window,
    counted as its rgb||flow row comes back from the card (the loop's
    ``on_window`` hook) and checked in the ``.npy`` its video writes;
  * ``per_video``: ``extract(path)`` per video (the import API, the
    per-video loop ``run_batches``), in seeded orders; the item is a
    flow field returned, counted as its video returns.

Each warms every shape the window uses on one video first. The window
opens at the first readback after the loop starts and closes at the last
one within ``seconds`` of it; every item that came back in between
counts, over all of that time.
"""
from __future__ import annotations

import gc
import importlib
import shutil
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from portbench.harness import check, clock, corpus, trace, weights as wts

# completions closer than this came back with one step's readback
BURST_S = 0.002


class Run:
    """What one run measured; the metric readers read its attributes."""

    def __init__(self, cell, seconds: float, traced: bool, device: str) -> None:
        self.cell, self.seconds, self.traced = cell, seconds, traced
        self.device = device
        self.unit = cell.traffic['unit']
        self.peak_flops = float(cell.config_file['peak']['tflops']) * 1e12
        self.setup_s: Optional[float] = None
        self.t_a = self.t_b = None
        self.items = self.attempted = self.failed = 0
        self.spans: Optional[trace.SpanLog] = trace.SpanLog() if traced else None
        self.device_trace: Optional[trace.DeviceTrace] = None
        self.slots = None                 # (valid, capacity) of the steps
        self.flops_per_item: Optional[float] = None
        self.range_flops: Dict[str, float] = {}
        self.memory_peak_bytes = 0
        self.setup_parts: Dict[str, float] = {}   # process age at each step
        self.checks: Dict[str, dict] = {}
        self.correct = False
        self.offset_ns = trace.epoch_offset_ns()

    @property
    def window_s(self) -> float:
        return self.t_b - self.t_a

    def close_window(self, done: List[tuple]) -> List[tuple]:
        """Set the window from ``done`` [(t, what), ...] in completion
        order; returns the completions inside it. Completions less than
        :data:`BURST_S` apart came back with one readback: the window
        opens after the first such burst and closes at the end of the
        last one within ``seconds``."""
        if not done:
            raise RuntimeError('nothing came back in the window')
        bursts: List[List[tuple]] = []
        for d in done:
            if bursts and d[0] - bursts[-1][-1][0] < BURST_S:
                bursts[-1].append(d)
            else:
                bursts.append([d])
        t_a = bursts[0][-1][0]
        later = [b for b in bursts[1:] if b[-1][0] <= t_a + self.seconds]
        if not later:
            raise RuntimeError('nothing came back after the first readback: '
                               'make --seconds longer')
        inside = [d for b in later for d in b]
        self.t_a, self.t_b = t_a, inside[-1][0]
        return inside


def _program_overrides(cell, ckpts: Dict[str, str], out_root: Path,
                       tmp_root: Path, device: str,
                       overrides: Optional[dict] = None) -> dict:
    """The program's config keys for this run: the configuration's, the
    traffic mix's (the lane), the checkpoints, the run's directories."""
    cf = cell.config_file
    args = dict(cf['program'])
    args.update(cell.traffic.get('program', {}))
    args.update({cf['checkpoints'][m]: p for m, p in ckpts.items()})
    args.update(output_path=str(out_root), tmp_path=str(tmp_root),
                device=device)
    args.update(overrides or {})
    return args


def _extractor(run, overrides: dict, paths: List[str], step_patch=None):
    """The extractor the configuration names, built by the program's own
    config loader and registry; traced runs give it a kept tracer."""
    from video_features_torch.config import load_config
    from video_features_torch.registry import create_extractor
    ex = create_extractor(load_config(run.cell.config_file['feature_type'],
                                      dict(overrides, video_paths=paths)))
    if step_patch is not None:
        step_patch(ex)
    if run.traced:
        ex.tracer = trace.kept_tracer(run.spans)
    run.setup_parts['extractor'] = clock.process_age_s()
    return ex


def _finish(run) -> None:
    """After the window: the peak device memory, then the program's
    state freed for the reference."""
    import torch
    gc.collect()
    if run.device.startswith('cuda'):
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        torch.cuda.empty_cache()


def _ranges(run):
    """The benchmark's ranges around the program's layers (traced runs):
    the configuration's ``ranges``, {range: "module:function"}."""
    if not run.traced:
        return nullcontext()
    targets = {}
    for name, where in run.cell.config_file['ranges'].items():
        module, attr = where.split(':')
        targets[name] = (importlib.import_module(module), attr)
    return trace.ranges(targets)


def _device_trace(run, prof) -> trace.DeviceTrace:
    return trace.DeviceTrace(prof.events, int(run.t_a * 1e9) + run.offset_ns,
                             int(run.t_b * 1e9) + run.offset_ns)


def _sync(device: str) -> None:
    import torch
    if device.startswith('cuda'):
        torch.cuda.synchronize()


def execute(cell, seed: int, seconds: float, traced: bool, device: str = 'cuda',
            program_overrides: Optional[dict] = None, step_patch=None) -> Run:
    """One run of ``cell``: set-up, the window, then the check against
    the reference. ``program_overrides`` replaces config keys (the
    control's lane); ``step_patch(extractor)`` breaks the timed path on
    purpose (the harness's own tests)."""
    run = Run(cell, seconds, traced, device)
    scratch = Path(tempfile.mkdtemp(prefix='portbench-'))
    try:
        run.setup_parts['imports'] = clock.process_age_s()
        clips = corpus.ensure(cell.traffic['corpus'], cell.corpus_root)
        run.setup_parts['corpus'] = clock.process_age_s()
        models = cell.config_file['models']
        ckpts = wts.write_checkpoints(wts.make_weights(models, seed, device),
                                      scratch / 'weights')
        run.setup_parts['weights'] = clock.process_age_s()
        overrides = _program_overrides(cell, ckpts, scratch / 'out',
                                       scratch / 'tmp', device,
                                       program_overrides)
        if cell.traffic['driver'] not in DRIVERS:
            raise ValueError(f'traffic {cell.traffic_name!r} names no driver '
                             f'of {sorted(DRIVERS)}: {cell.traffic["driver"]!r}')
        driver = DRIVERS[cell.traffic['driver']]
        sample = driver(run, overrides, clips, scratch,
                        np.random.default_rng(seed), step_patch)
        _finish(run)
        reference = wts.make_weights(models, seed, device)
        run.checks = check.compare(cell, sample, reference, device)
        run.correct = (run.items > 0 and run.failed == 0 and
                       all(c['value'] <= c['limit'] for c in run.checks.values()))
        if traced:
            run.flops_per_item, run.range_flops = cell.family.flops(cell)
        return run
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def packed_corpus(run: Run, overrides: dict, clips: List[dict],
                  scratch: Path, rng, step_patch=None) -> list:
    """The packed loop over seeded passes of the corpus; returns the
    check's sample: [{"clip", "file", "picked"}] of every video with a
    row in the window, ``picked`` drawn from the seed."""
    from video_features_torch.parallel.packing import VideoTask
    ex = _extractor(run, overrides, [c['path'] for c in clips], step_patch)
    ex.extract_packed([VideoTask(clips[0]['path'], out_root=str(scratch / 'warm'))])
    _sync(run.device)
    rows: List[tuple] = []            # (t, task): each row as it comes back
    ended: List[tuple] = []           # (t, task): each video as it ends
    by_path = {c['path']: c for c in clips}

    class TimedTask(VideoTask):
        """A video whose rows are timed as the loop reads them back."""

        def on_window(self, feats, meta) -> None:
            rows.append((time.perf_counter(), self))

    def tasks():
        k = 0
        while True:
            for i in rng.permutation(len(clips)):
                if rows and time.perf_counter() >= rows[0][0] + run.seconds:
                    return
                yield TimedTask(clips[i]['path'],
                                out_root=str(scratch / 'out' / f'pass{k}'))
            k += 1

    run.setup_s = clock.process_age_s()
    with (trace.profiled() if run.traced else nullcontext()) as prof, _ranges(run):
        ex.extract_packed(tasks(),
                          on_video_done=lambda t: ended.append((time.perf_counter(), t)))
        _sync(run.device)
    inside = run.close_window(rows)
    lost = sum(t.emitted for at, t in ended
               if run.t_a < at <= run.t_b and (t.failed or t.skipped))
    run.items = len(inside)
    run.attempted, run.failed = run.items + lost, lost
    if run.traced:
        run.device_trace = _device_trace(run, prof)
        run.slots = ex.tracer.merged().get('model', {})
    videos = list(dict.fromkeys(task for _, task in inside))
    picked = check.pick_videos([(None, t) for t in videos], rng,
                               run.cell.traffic['check']['videos'],
                               key=lambda d: d[1].path)
    return [{'clip': by_path[t.path], 'picked': t in picked,
             'file': str(Path(t.out_root) / f'{Path(t.path).stem}.npy')}
            for t in videos]


def per_video(run: Run, overrides: dict, clips: List[dict], scratch: Path,
              rng, step_patch=None) -> list:
    """``extract(path)`` per video over seeded passes of the corpus;
    returns the check's sample: ``pairs`` flows drawn from the seed in
    each of the videos drawn among the first the window ran."""
    ex = _extractor(run, overrides, [c['path'] for c in clips], step_patch)
    ex.extract(min(clips, key=lambda c: c['frames'])['path'])
    _sync(run.device)
    key = ex.feature_type
    cfg = run.cell.traffic['check']
    order = [i for _ in range(64) for i in rng.permutation(len(clips))]
    keep = set(check.pick_positions(order, cfg['from_first'], cfg['videos'], rng))
    kept: Dict[int, np.ndarray] = {}
    done: List[tuple] = []
    steps = [0]
    if run.traced:
        dispatch = ex.dispatch

        def counted(batch, _d=dispatch):
            steps[0] += 1
            return _d(batch)
        ex.dispatch = counted
    run.setup_s = clock.process_age_s()
    with (trace.profiled() if run.traced else nullcontext()) as prof, _ranges(run):
        for pos, i in enumerate(order):
            if done and time.perf_counter() >= done[0][0] + run.seconds:
                break
            out = ex.extract(clips[i]['path'])
            done.append((time.perf_counter(), (pos, len(out[key]))))
            if pos in keep:
                kept[pos] = out[key]
        _sync(run.device)
    run.items = run.attempted = sum(n for _, (_, n) in run.close_window(done))
    if run.traced:
        run.device_trace = _device_trace(run, prof)
        flows_run = sum(n for _, (_, n) in done)
        run.slots = {'occ_valid': flows_run,
                     'occ_capacity': steps[0] * int(ex.batch_size)}
    for pos in keep - set(kept):        # drawn but not reached in the window
        kept[pos] = ex.extract(clips[order[pos]]['path'])[key]
    out = []
    for pos in sorted(kept):
        n = len(kept[pos])
        pairs = sorted(rng.choice(n, min(cfg['pairs'], n), replace=False)) if n else []
        out.append({'clip': clips[order[pos]], 'frames_out': n,
                    'pairs': [int(p) for p in pairs],
                    'flows': kept[pos][pairs] if n else kept[pos]})
    return out


DRIVERS = {'packed_corpus': packed_corpus, 'per_video': per_video}
