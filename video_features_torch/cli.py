"""CLI entry point: ``python -m video_features_torch feature_type=<family>
key=val ...`` (families: i3d, r21d, s3d, raft, resnet, clip, timm,
vggish), or ``features=[f1,f2,...] key=val ...`` for a fused worklist.

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


def main(argv: Optional[List[str]] = None) -> int:
    import yaml
    argv = sys.argv[1:] if argv is None else argv
    cli_args = parse_dotlist(argv)
    if 'features' in cli_args:
        return _fused_main(cli_args)
    if 'feature_type' not in cli_args:
        print('Usage: python -m video_features_torch '
              f'feature_type={"|".join(EXTRACTORS)} [key=value ...]\n'
              '       python -m video_features_torch features=[f1,f2,...] '
              '[<family>.key=value ...] [key=value ...]')
        return 2
    args = load_config(cli_args['feature_type'], overrides=cli_args)
    print(yaml.safe_dump(dict(args), sort_keys=False, default_flow_style=False))
    if args['on_extraction'] in ('save_numpy', 'save_pickle'):
        print(f'Saving features to {args["output_path"]}')
    print('Device:', args['device'])

    extractor = create_extractor(args)
    install_dump(extractor)
    video_paths = form_list_from_user_input(
        args.get('video_paths'), args.get('file_with_video_paths'))
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
    return 0


def _fused_main(cli_args: dict) -> int:
    """``features=[...]``: one config and extractor per family; families
    whose ``fused_decode_signature()`` match share one decode pass, the
    others run their own pass. Each family's files, resume and fault
    isolation are those of its sequential run."""
    from video_features_torch.farm import merge_farm_stats
    from video_features_torch.parallel.packing import run_packed_fused
    configs = load_fused_configs(cli_args['features'], overrides=cli_args)
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
    video_paths = form_list_from_user_input(
        shared.get('video_paths'), shared.get('file_with_video_paths'))
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
    return 0
