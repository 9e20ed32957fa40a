"""Seeded random weights, made on the device in two large draws (one
normal, one uniform) and sliced into a state dict per model."""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict, List, Tuple

import torch

# kind -> (draw, scale, offset): value = offset + scale · draw
KINDS = {
    'conv': ('normal', 0.05, 0.0),
    'bias': ('normal', 0.05, 0.0),
    'bn_weight': ('uniform', 1.0, 0.5),
    'bn_bias': ('normal', 0.1, 0.0),
    'bn_mean': ('normal', 0.1, 0.0),
    'bn_var': ('uniform', 1.0, 0.5),
    # RAFT's last flow-head conv: 20 iterations then give flows of a few
    # pixels, as on real video, not hundreds beyond the flow clamp
    'flow_out': ('normal', 0.001, 0.0),
}


def model_leaves(spec: dict) -> List[Tuple[str, tuple, str]]:
    """A configuration's ``models`` entry ({"reference": module, "args":
    [...]}) → that reference module's ``leaves(*args)``."""
    module = importlib.import_module(f'portbench.reference.{spec["reference"]}')
    return module.leaves(*spec.get('args', []))


def make_weights(models: Dict[str, dict], seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: state dict}, every leaf drawn from ``seed`` on ``device``
    as float32, in the order of the configuration's models."""
    layout = {name: model_leaves(spec) for name, spec in models.items()}
    counts = {'normal': 0, 'uniform': 0}
    for leaves in layout.values():
        for _, shape, kind in leaves:
            counts[KINDS[kind][0]] += torch.Size(shape).numel()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    draws = {'normal': torch.randn(counts['normal'], generator=gen,
                                   device=device),
             'uniform': torch.rand(counts['uniform'], generator=gen,
                                   device=device)}
    offsets = {'normal': 0, 'uniform': 0}
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for model, leaves in layout.items():
        sd = out[model] = {}
        for name, shape, kind in leaves:
            draw, scale, offset = KINDS[kind]
            n = torch.Size(shape).numel()
            start = offsets[draw]
            offsets[draw] += n
            sd[name] = (draws[draw][start:start + n].reshape(shape) * scale
                        + offset)
    return out


def write_checkpoints(weights: Dict[str, Dict[str, torch.Tensor]],
                      root: Path) -> Dict[str, str]:
    """Each state dict saved as ``<root>/<model>.pt`` (the program's
    checkpoint format); returns {model: path}."""
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for model, sd in weights.items():
        path = root / f'{model}.pt'
        torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)
        paths[model] = str(path)
    return paths
