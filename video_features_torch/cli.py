"""CLI entry point: ``python -m video_features_torch feature_type=<family>
key=val ...`` (families: i3d, r21d, s3d, raft, resnet, clip, timm,
vggish).

Load the family's YAML, merge the dotlist (CLI wins), sanity-check,
build the extractor, shuffle the video list and run ``_extract`` per
video with fault isolation, or with ``pack_across_videos=true`` the
packed loop over the whole list (``extract_packed``).
"""
from __future__ import annotations

import sys
from typing import List, Optional

from video_features_torch.config import (
    form_list_from_user_input, load_config, parse_dotlist,
)
from video_features_torch.registry import EXTRACTORS, create_extractor


def main(argv: Optional[List[str]] = None) -> int:
    import yaml
    argv = sys.argv[1:] if argv is None else argv
    cli_args = parse_dotlist(argv)
    if 'features' in cli_args:
        raise NotImplementedError(
            'features=[...] (a fused worklist: one decode, several families) '
            'is not ported yet: run each family with feature_type=<family>')
    if 'feature_type' not in cli_args:
        print('Usage: python -m video_features_torch '
              f'feature_type={"|".join(EXTRACTORS)} [key=value ...]')
        return 2
    args = load_config(cli_args['feature_type'], overrides=cli_args)
    print(yaml.safe_dump(dict(args), sort_keys=False, default_flow_style=False))
    if args['on_extraction'] in ('save_numpy', 'save_pickle'):
        print(f'Saving features to {args["output_path"]}')
    print('Device:', args['device'])

    extractor = create_extractor(args)
    video_paths = form_list_from_user_input(
        args.get('video_paths'), args.get('file_with_video_paths'))
    print(f'The number of specified videos: {len(video_paths)}')
    if args.get('pack_across_videos'):
        print(f'Packing device batches across {len(video_paths)} videos')
        extractor.extract_packed(video_paths,
                                 decode_ahead=int(args['pack_decode_ahead']))
        return 0
    for i, video_path in enumerate(video_paths):
        print(f'[{i + 1}/{len(video_paths)}] {video_path}')
        extractor._extract(video_path)
    return 0
