"""Two places where the port had drifted from the JAX package, held to it
on the CPU: the decode farm's death dump and warning text
(video_features_torch/farm/farm.py::DecodeFarm._supervise), and RAFT's
flow-viz PNG write (video_features_torch/extract/raft.py::
ExtractRAFT.maybe_show_pred), which must report any failure through the
event log and never fail the extraction."""
import inspect
import re

import numpy as np
import pytest

from video_features_torch.extract import raft as extract
from video_features_torch.io import video
from video_features_torch.obs import events

FPS = 25.0


def test_farm_death_reason_and_event_text_are_the_jax_packages():
    """The bundle reason and the warning's wording, read from both
    packages' ``_supervise`` source, are the same strings."""
    from video_features_tpu.farm import farm as jax_farm
    from video_features_torch.farm import farm as port_farm
    jax_src = inspect.getsource(jax_farm.DecodeFarm._supervise)
    port_src = inspect.getsource(port_farm.DecodeFarm._supervise)
    reason = re.compile(r"_blackbox\.dump\(\s*'(\w+)'")
    assert reason.findall(jax_src) == ['farm_worker_death']
    assert reason.findall(port_src) == reason.findall(jax_src)
    text = re.compile(r"died '\s*f'\(exitcode \{w\.proc\.exitcode\}\); '"
                      r"|respawning with \{len\(requeue\)\} queued video\(s\)"
                      r"|no video in flight|decode farm worker \{w\.idx\} ")
    jax_parts = text.findall(jax_src)
    assert len(set(jax_parts)) == 4
    assert set(text.findall(port_src)) == set(jax_parts)


@pytest.mark.parametrize('fault', ['output_path_is_a_file', 'imwrite_raises'])
def test_flow_viz_failure_is_an_event_and_extraction_goes_on(
        tmp_path, monkeypatch, fault):
    out = tmp_path / 'out'
    if fault == 'output_path_is_a_file':
        out.write_bytes(b'')            # flow_debug/ cannot be made under it
    else:
        import cv2

        def imwrite(*a, **k):
            raise cv2.error('imwrite refused')
        monkeypatch.setattr(cv2, 'imwrite', imwrite)
    ex = extract.ExtractRAFT({
        'feature_type': 'raft', 'batch_size': 2, 'raft_iters': 1,
        'device': 'cpu', 'allow_random_weights': True, 'show_pred': True,
        'on_extraction': 'save_numpy', 'output_path': str(out)})
    frames = list(np.random.RandomState(0).randint(
        0, 256, (3, 64, 64, 3)).astype(np.uint8))
    before = events.event_counts().get(('WARNING', 'raft'), 0)
    feats = ex.extract_frames(
        video.batch_frames(iter(frames), 3, FPS, overlap=1), FPS)
    assert feats['raft'].shape == (2, 2, 64, 64)
    assert events.event_counts()[('WARNING', 'raft')] == before + 1
    last = [e for e in events.events_tail(8) if e['subsystem'] == 'raft']
    assert last[-1]['msg'] == 'flow viz PNG write skipped'
    assert last[-1]['level'] == 'WARNING' and 'exc' in last[-1]
