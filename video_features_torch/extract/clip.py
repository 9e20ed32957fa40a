"""CLIP frame-wise extractor (port of ``video_features_tpu/extract/
clip.py``).

OpenAI's preprocessing: a PIL bicubic edge resize to the model's input
resolution and a center crop on the host, then on the device [0, 1] →
normalize (CLIP's mean and std) → ``encode_image``.

Checkpoint sources, in order: ``checkpoint_path`` (a ``.pt``/``.pth``
state_dict or pickled model, OpenAI's fp16 weights upcast to fp32, or a
``.npz`` in the JAX package's layout); ``model_name=custom`` without a
path loads ``./checkpoints/CLIP-custom.pth``, and the architecture of a
custom checkpoint is inferred from its shapes; otherwise the gated
random init, which exists for the ViT models only.

``show_pred`` is zero-shot classification: each frame's cosine logits
against ``"a photo of {label}"`` for the Kinetics-400 labels, or against
``pred_texts``; the text features are computed once per run. Without
the BPE vocab it prints ``show_pred unavailable: …`` and returns.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from video_features_torch.config import check_lanes
from video_features_torch.extract.framewise import BaseFrameWiseExtractor
from video_features_torch.models import clip as clip_model
from video_features_torch.ops.nn import three_pass_route
from video_features_torch.ops.precision import features_to_f32
from video_features_torch.ops.quant import dequantize_tree
from video_features_torch.ops.transforms import normalize, to_float_zero_one
from video_features_torch.transplant import (
    Params, float32_params, load_checkpoint, params_from_torch, to_device,
)
from video_features_torch.utils.device import resolve_device
from video_features_torch.utils.fingerprint import CLIP_CUSTOM_CHECKPOINT


def clip_step(params, frames: torch.Tensor, arch: str,
              dtype: torch.dtype = torch.float32,
              three_pass_convs: bool = False) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, embed_dim) float32: [0, 1] in ``dtype``
    (the lane's activations) → normalize → ``encode_image``, every
    convolution, linear and product in the hand kernels under
    ``three_pass_convs``; int8 weights are dequantized first."""
    x = normalize(to_float_zero_one(frames, dtype), clip_model.MEAN,
                  clip_model.STD)
    with three_pass_route(three_pass_convs, products=True):
        return features_to_f32(clip_model.encode_image(
            dequantize_tree(params), x, arch))


def load_params(args, compute_dtype: str = 'float32') -> Tuple[Params, str]:
    """(params, arch) from the configured checkpoint source, cast for the
    ``compute_dtype`` lane."""
    from video_features_torch.extract.weights import lane_params
    model_name = args.get('model_name', 'ViT-B/32')
    if model_name != 'custom':
        clip_model.model_def(model_name)
    ckpt = args.get('checkpoint_path')
    if model_name == 'custom' and not ckpt:
        ckpt = CLIP_CUSTOM_CHECKPOINT
    if not ckpt:
        from video_features_torch.extract.weights import require_checkpoint
        require_checkpoint(args, 'checkpoint_path', feature_type='clip',
                           what=f'clip ({model_name})')
        params = params_from_torch(clip_model.init_state_dict(model_name=model_name))
    else:   # OpenAI's archives are pickled models of fp16 weights (→ fp32)
        params = load_checkpoint(str(ckpt), no_transpose=clip_model.NO_TRANSPOSE,
                                 weights_only=False)
    arch = (clip_model.infer_model_name_from_params(params)
            if model_name == 'custom' else model_name)
    return lane_params(params, compute_dtype, ckpt,
                       clip_model.NO_TRANSPOSE), arch


class ExtractCLIP(BaseFrameWiseExtractor):

    def __init__(self, args) -> None:
        resolve_device(args.get('device', 'cuda'))   # before the weights load
        params, self.arch = load_params(args, check_lanes(args)[1])
        self.model_name = args.get('model_name', 'ViT-B/32')
        cfg = clip_model.VISUAL_CFGS[self.arch]
        super().__init__(args, feat_dim=cfg['embed_dim'])
        self.input_resolution = cfg['input_resolution']
        self.pred_texts: Optional[List[str]] = (
            list(args['pred_texts']) if args.get('pred_texts') else None)
        self.params = to_device(params, self.device)
        self._text: Optional[Tuple[torch.Tensor, List[str]]] = None
        if self.data_parallel:
            self._ensure_mesh('batch_size')

    def host_transform_spec(self):
        n_px = self.input_resolution
        return ('edge_resize_crop', n_px, n_px, 'bicubic')

    def step_program(self):
        return clip_step, dict(arch=self.arch, dtype=self.act_dtype,
                               three_pass_convs=self.three_pass_convs)

    def text_features(self) -> Tuple[Optional[torch.Tensor], List[str]]:
        """(text features, class texts) of the zero-shot prompts, computed
        on the first call; (None, []) without a label map. Raises
        ``FileNotFoundError`` without the BPE vocab."""
        if self._text is None:
            from video_features_torch.utils.clip_tokenizer import tokenize
            from video_features_torch.utils.preds import load_label_map
            classes = self.pred_texts
            if classes is None:
                labels = load_label_map('kinetics')
                if labels is None:
                    # vft-lint: ok=stdout-purity — show_pred narration surface
                    print('show_pred: no Kinetics label map available — skipping')
                    return None, []
                classes = [f'a photo of {label}' for label in labels]
            tokens = torch.from_numpy(tokenize(classes)).to(self.device)
            with torch.inference_mode(), self.precision_scope(), \
                    three_pass_route(self.three_pass_convs, products=True):
                self._text = (clip_model.encode_text(
                    float32_params(self.params), tokens), classes)
        return self._text

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        """Each frame's zero-shot top-5."""
        from video_features_torch.utils.preds import show_predictions_on_dataset
        try:
            text_feats, classes = self.text_features()
        except FileNotFoundError as e:
            # vft-lint: ok=stdout-purity — show_pred narration surface
            print(f'show_pred unavailable: {e}')
            return
        if text_feats is None:
            return
        with torch.inference_mode(), self.precision_scope(), \
                three_pass_route(self.three_pass_convs, products=True):
            logits = clip_model.zero_shot_logits(
                float32_params(self.params),
                torch.from_numpy(feats).to(self.device), text_feats)
        show_predictions_on_dataset(logits.cpu().numpy(), classes)
