"""CLI entry point: ``python -m video_features_torch feature_type=<family>
key=val ...`` (families: i3d, r21d, s3d, raft, resnet, clip, timm,
vggish), or ``features=[f1,f2,...] key=val ...`` for a fused worklist;
``python -m video_features_torch serve ...`` starts the warm-pool daemon
(``serve/server.py::serve_main``).

Load the family's YAML, merge the dotlist (CLI wins), sanity-check,
build the extractor, shuffle the video list and run ``_extract`` per
video with fault isolation, or with ``pack_across_videos=true`` the
packed loop over the whole list (``extract_packed``). A fused worklist
gives each family its config (``config.load_fused_configs``; a
``<family>.<knob>=`` key reaches that family only): the frame-wise
families with equal decode signatures share one decode per video
(``parallel.packing.run_packed_fused``), and every other family runs
its own pass over the same list, packed where the family packs. With
``cache_enabled=true`` every path consults the feature cache through
the extractors ``create_extractor`` builds.

Several processes over one worklist (``multihost=true``, read from the
command line only): the process group comes up before the config loads
(``parallel/distributed.py``: ``coordinator_address``, ``num_processes``
and ``process_id`` on every process, or ``torchrun``'s environment),
each process takes its interleaved shard of the unshuffled list
(``parallel/worklist.py``), and all wait at a final barrier before they
leave the group.

The flight recorder on every path: ``profile_dir`` runs the worklist
inside ``torch.profiler`` (``utils/tracing.py::torch_profiler_trace``);
``trace_out`` and ``manifest_out`` are written by each extractor's
``finish_obs`` when the run ends, a failed video or an error included;
with ``postmortem_dir`` a fatal signal (SIGTERM, SIGQUIT, SIGABRT)
dumps a black-box bundle before the process goes down.
"""
from __future__ import annotations

import sys
from typing import List, Optional

from video_features_torch.config import (
    form_list_from_user_input, load_config, load_fused_configs, parse_dotlist,
)
from video_features_torch.registry import EXTRACTORS, create_extractor
from video_features_torch.utils.tracing import torch_profiler_trace


def install_dump(extractor) -> None:
    """With ``postmortem_dir``, a black-box dump on SIGTERM (a batch
    scheduler's kill), SIGQUIT and SIGABRT, each followed by the signal's
    own handling."""
    if extractor.blackbox is None:
        return
    import signal

    from video_features_torch.obs.blackbox import install_signal_dump
    install_signal_dump(extractor.blackbox, signals=tuple(
        getattr(signal, name) for name in ('SIGTERM', 'SIGQUIT', 'SIGABRT')
        if hasattr(signal, name)))


MULTIHOST_FROM_CONFIG = (
    'multihost must be passed on the command line (multihost=true), not via '
    'a config file: the distributed runtime must initialize before device '
    'probing')


def start_multihost(cli_args: dict) -> bool:
    """With ``multihost=true`` on the command line, join the process group
    (coordinator keys, ``torchrun``'s environment, or a one-process run
    with a warning); returns whether ``multihost`` was asked for."""
    multihost = bool(cli_args.get('multihost'))
    if multihost:
        from video_features_torch.parallel.distributed import initialize
        initialize(cli_args.get('coordinator_address'),
                   cli_args.get('num_processes'), cli_args.get('process_id'))
    return multihost


def worklist(args: dict, multihost: bool) -> List[str]:
    """The run's video list: shuffled for a single process, as the
    reference does, or this process's interleaved shard of the list in
    order with ``multihost``."""
    video_paths = form_list_from_user_input(
        args.get('video_paths'), args.get('file_with_video_paths'),
        to_shuffle=not multihost)
    if multihost:
        from video_features_torch.parallel.worklist import shard_worklist
        video_paths = shard_worklist(video_paths)
    return video_paths


def finish_multihost(multihost: bool) -> None:
    """Hold every process at the final barrier (a process that drew short
    videos must not leave while the others extract), then leave the
    group."""
    if not multihost:
        return
    from video_features_torch.parallel.distributed import (
        barrier, process_count, shutdown,
    )
    if process_count() > 1:
        barrier('extraction_done')
    shutdown()


def main(argv: Optional[List[str]] = None) -> int:
    import yaml
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == 'serve':
        # the warm-pool daemon (serve/): extractors stay resident and
        # requests over a loopback socket pack into shared batches
        from video_features_torch.serve.server import serve_main
        return serve_main(argv[1:])
    cli_args = parse_dotlist(argv)
    if 'feature_type' not in cli_args and 'features' not in cli_args:
        print('Usage: python -m video_features_torch '
              f'feature_type={"|".join(EXTRACTORS)} [key=value ...]\n'
              '       python -m video_features_torch features=[f1,f2,...] '
              '[<family>.key=value ...] [key=value ...]\n'
              '       python -m video_features_torch serve [serve_port=N ...] '
              '[key=value ...]')
        return 2
    multihost = start_multihost(cli_args)
    if 'features' in cli_args:
        return _fused_main(cli_args, multihost)
    args = load_config(cli_args['feature_type'], overrides=cli_args)
    if args.get('multihost') and not multihost:
        raise ValueError(MULTIHOST_FROM_CONFIG)
    print(yaml.safe_dump(dict(args), sort_keys=False, default_flow_style=False))
    if args['on_extraction'] in ('save_numpy', 'save_pickle'):
        print(f'Saving features to {args["output_path"]}')
    print('Device:', args['device'])

    extractor = create_extractor(args)
    install_dump(extractor)
    video_paths = worklist(args, multihost)
    print(f'The number of specified videos: {len(video_paths)}')
    try:
        with torch_profiler_trace(args.get('profile_dir')):
            if args.get('pack_across_videos'):
                print(f'Packing device batches across {len(video_paths)} '
                      'videos')
                extractor.extract_packed(
                    video_paths, decode_ahead=int(args['pack_decode_ahead']))
            else:
                for i, video_path in enumerate(video_paths):
                    print(f'[{i + 1}/{len(video_paths)}] {video_path}')
                    extractor._extract(video_path)
    finally:
        extractor.finish_obs()
    finish_multihost(multihost)
    return 0


def _fused_main(cli_args: dict, multihost: bool = False) -> int:
    """``features=[...]``: one config and extractor per family; families
    whose ``fused_decode_signature()`` match share one decode pass, the
    others run their own pass. Each family's files, resume and fault
    isolation are those of its sequential run."""
    from video_features_torch.farm import merge_farm_stats
    from video_features_torch.parallel.packing import run_packed_fused
    configs = load_fused_configs(cli_args['features'], overrides=cli_args)
    if any(a.get('multihost') for a in configs.values()) and not multihost:
        raise ValueError(MULTIHOST_FROM_CONFIG)
    print(f'Fused worklist ({len(configs)} families): ' + ', '.join(configs))
    for fam, args in configs.items():
        line = f'  {fam}: device={args["device"]} on_extraction={args["on_extraction"]}'
        if args['on_extraction'] in ('save_numpy', 'save_pickle'):
            line += f' -> {args["output_path"]}'
        print(line)
    exs = {fam: create_extractor(args) for fam, args in configs.items()}
    install_dump(next(iter(exs.values())))
    # the worklist keys are shared overrides: every family has the same
    shared = next(iter(configs.values()))
    video_paths = worklist(shared, multihost)
    print(f'The number of specified videos: {len(video_paths)}')

    groups: dict = {}
    singles: List[str] = []
    for fam, ex in exs.items():
        sig = ex.fused_decode_signature()
        if sig is None:
            singles.append(fam)
        else:
            groups.setdefault(sig, {})[fam] = ex
    singles += [fam for g in groups.values() if len(g) == 1 for fam in g]
    decode_ahead = int(shared['pack_decode_ahead'])
    try:
        with torch_profiler_trace(shared.get('profile_dir')):
            for group in (g for g in groups.values() if len(g) > 1):
                print(f'Fusing decode for [{", ".join(group)}]: one pass over '
                      f'{len(video_paths)} videos')
                run_packed_fused(group, list(video_paths),
                                 decode_ahead=decode_ahead)
            for fam in singles:
                ex = exs[fam]
                print(f'[{fam}] cannot share a decode pass: running its own')
                if ex.supports_packing:
                    ex.extract_packed(list(video_paths),
                                      decode_ahead=decode_ahead)
                    continue
                for i, video_path in enumerate(video_paths):
                    print(f'[{fam}] [{i + 1}/{len(video_paths)}] {video_path}')
                    ex._extract(video_path)
    finally:
        for ex in exs.values():
            ex.finish_obs()
    farms = [ex._farm.stats() for ex in exs.values() if ex._farm is not None]
    if farms:
        s = merge_farm_stats(farms)
        print(f'decode farm: {s["videos_assigned"]} video decodes, '
              f'{s["windows"]} windows, {s["queue_fallback"]} queue '
              f'fallbacks, {s["respawns"]} respawns over {len(farms)} '
              'pass(es)', file=sys.stderr)
    finish_multihost(multihost)
    return 0
