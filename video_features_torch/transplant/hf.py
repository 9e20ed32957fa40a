"""HuggingFace ``transformers`` checkpoints re-keyed into the layouts the
port loads (the port's copy of ``video_features_tpu/transplant/hf.py``).

The port's timm-layout families (``models/{vit,beit,convnext,swin,
regnet}.py``) load torch checkpoints in timm naming, and ``models/clip.py``
loads OpenAI CLIP naming. ``transformers`` hosts the same published
architectures under another module tree; the re-keying is mechanical and
moves no number: every array comes out as it went in, concatenated where
the target fuses q/k/v, transposed where OpenAI's CLIP keeps a raw
right-hand operand.

Functions take a flat HF state dict (torch tensors or numpy arrays) and
return the target-named dict. Structural deltas per family:

  * vit: HF splits q/k/v projections; timm packs ``qkv``.
  * deit: the vit mapping plus HF's ``distillation_token`` → timm
    ``dist_token`` (a timm DeiT name resolves to its vit geometry).
  * convnext: HF calls blocks ``layers`` and the timm ``gamma`` layer
    scale ``layer_scale_parameter``; the head LN is HF's pooler norm.
  * swin: q/k/v packing as vit, plus HF hangs each PatchMerging off the
    END of stage L where timm 0.9.12 puts it at the START of stage L+1.
  * regnet: HF nests each block's conv stack in a Sequential
    (layer.0/1/3 = conv1/conv2/conv3, layer.2 = SE) and calls the
    projection ``shortcut``.
  * beit: q/k/v split as vit but k carries NO bias (timm packs
    ``q_bias``/``v_bias``); HF names the layer scales
    ``lambda_1``/``lambda_2`` (timm ``gamma_1``/``gamma_2``), hangs the
    relative position bias table under
    ``attention.attention.relative_position_bias``, and the timm
    ``fc_norm`` is HF's pooler layernorm.
  * clip (:func:`clip_to_openai`): HF splits q/k/v where OpenAI fuses
    ``attn.in_proj_*``, and its projection heads are transposed.

Each family's geometry comes from the port's own model tables.

Run as a script, it converts a checkpoint file::

    python -m video_features_torch.transplant.hf SRC DST --hf-family vit \
        --arch vit_tiny_patch16_224 [--key state_dict]

writing a torch ``.pt`` in timm (or, for ``clip``, OpenAI CLIP) naming
that ``checkpoint_path=DST`` loads.
"""
from __future__ import annotations

from typing import Any, Dict

Sd = Dict[str, Any]


def _cat0(parts):
    first = parts[0]
    if hasattr(first, 'detach'):     # torch tensor
        import torch
        return torch.cat(list(parts), dim=0)
    import numpy as np
    return np.concatenate(list(parts), axis=0)


def _t2(x):
    """2-D transpose for a torch tensor or numpy array."""
    if hasattr(x, 'detach'):
        return x.detach().t().contiguous()
    import numpy as np
    return np.ascontiguousarray(np.asarray(x).T)


# key stems every supported HF backbone subtree contains at top level —
# the guard that a candidate prefix really wraps a backbone, not some
# unrelated module that happens to be named e.g. 'model'
_BACKBONE_MARKERS = ('embeddings.', 'encoder.', 'embedder.')
# keys legitimately discarded when unwrapping a *ForImageClassification
# checkpoint (the task head the feature path never uses)
_EXPECTED_DISCARDS = ('classifier.',)


def strip_task_prefix(hf_sd: Sd) -> Sd:
    """Drop a task-model wrapper: ``vit.``/``swin.``/... key prefixes from
    *ForImageClassification checkpoints (and their classifier head).

    Only strips when the prefixed subtree actually looks like a backbone
    (contains an ``embeddings.``/``encoder.`` stem), and refuses to
    silently discard keys outside the prefix other than the classifier
    head — a mixed or unexpectedly-named checkpoint errors instead of
    being mangled."""
    prefixes = {k.split('.', 1)[0] for k in hf_sd if '.' in k}
    for p in ('vit', 'deit', 'beit', 'swin', 'convnext', 'regnet', 'model'):
        if p not in prefixes:
            continue
        sub = {k[len(p) + 1:]: v for k, v in hf_sd.items()
               if k.startswith(p + '.')}
        if not any(k.startswith(_BACKBONE_MARKERS) for k in sub):
            continue  # a coincidental module name, not the backbone wrapper
        dropped = [k for k in hf_sd
                   if not k.startswith(p + '.')
                   and not k.startswith(_EXPECTED_DISCARDS)]
        if dropped:
            raise ValueError(
                f'checkpoint mixes {p}.*-prefixed backbone keys with '
                f'unprefixed keys that are not a classifier head '
                f'(e.g. {dropped[:3]}); refusing to silently discard them')
        return sub
    return hf_sd


def vit_to_timm(hf_sd: Sd, arch: str) -> Sd:
    """transformers.ViTModel → timm VisionTransformer naming."""
    from video_features_torch.models.vit import ARCHS
    depth = ARCHS[arch]['layers']
    sd = {
        'cls_token': hf_sd['embeddings.cls_token'],
        'pos_embed': hf_sd['embeddings.position_embeddings'],
        'patch_embed.proj.weight':
            hf_sd['embeddings.patch_embeddings.projection.weight'],
        'patch_embed.proj.bias':
            hf_sd['embeddings.patch_embeddings.projection.bias'],
        'norm.weight': hf_sd['layernorm.weight'],
        'norm.bias': hf_sd['layernorm.bias'],
    }
    for i in range(depth):
        h, t = f'encoder.layer.{i}.', f'blocks.{i}.'
        for ours, theirs in [('norm1', 'layernorm_before'),
                             ('norm2', 'layernorm_after'),
                             ('attn.proj', 'attention.output.dense'),
                             ('mlp.fc1', 'intermediate.dense'),
                             ('mlp.fc2', 'output.dense')]:
            sd[t + ours + '.weight'] = hf_sd[h + theirs + '.weight']
            sd[t + ours + '.bias'] = hf_sd[h + theirs + '.bias']
        for p in ('weight', 'bias'):
            sd[t + f'attn.qkv.{p}'] = _cat0(
                [hf_sd[h + f'attention.attention.{proj}.{p}']
                 for proj in ('query', 'key', 'value')])
    return sd


def deit_to_timm(hf_sd: Sd, arch: str) -> Sd:
    """transformers.DeiTModel (distilled) → timm
    VisionTransformerDistilled naming: the ViT mapping plus the
    distillation token (timm ``dist_token``); the 2-slot prefix rides
    ``position_embeddings`` unchanged. ``arch`` may be the timm DeiT name
    (``deit_tiny_distilled_patch16_224``) or its underlying vit geometry —
    DeiT IS timm's VisionTransformer (extract/timm.py aliases them)."""
    if arch.startswith('deit'):
        arch = arch.replace('deit', 'vit', 1).replace('_distilled', '')
    sd = vit_to_timm(hf_sd, arch)
    sd['dist_token'] = hf_sd['embeddings.distillation_token']
    return sd


def beit_to_timm(hf_sd: Sd, arch: str) -> Sd:
    """transformers.BeitModel → timm Beit naming. HF registers the
    ``relative_position_index`` buffers non-persistent, so they are
    regenerated here from the arch geometry (the published BEiT formula —
    identical in timm, HF, and models/beit.py)."""
    from video_features_torch.models.beit import (
        ARCHS, INPUT_RESOLUTION, gen_relative_position_index,
    )
    depth = ARCHS[arch]['layers']
    side = INPUT_RESOLUTION // ARCHS[arch]['patch']
    index = gen_relative_position_index((side, side))
    sd = {
        'cls_token': hf_sd['embeddings.cls_token'],
        'patch_embed.proj.weight':
            hf_sd['embeddings.patch_embeddings.projection.weight'],
        'patch_embed.proj.bias':
            hf_sd['embeddings.patch_embeddings.projection.bias'],
        'fc_norm.weight': hf_sd['pooler.layernorm.weight'],
        'fc_norm.bias': hf_sd['pooler.layernorm.bias'],
    }
    for i in range(depth):
        h, t = f'encoder.layer.{i}.', f'blocks.{i}.'
        a = h + 'attention.attention.'
        sd[t + 'attn.qkv.weight'] = _cat0(
            [hf_sd[a + f'{proj}.weight']
             for proj in ('query', 'key', 'value')])
        sd[t + 'attn.q_bias'] = hf_sd[a + 'query.bias']
        sd[t + 'attn.v_bias'] = hf_sd[a + 'value.bias']
        rb = a + 'relative_position_bias.'
        sd[t + 'attn.relative_position_bias_table'] = hf_sd[
            rb + 'relative_position_bias_table']
        sd[t + 'attn.relative_position_index'] = index
        sd[t + 'gamma_1'] = hf_sd[h + 'lambda_1']
        sd[t + 'gamma_2'] = hf_sd[h + 'lambda_2']
        for ours, theirs in [('norm1', 'layernorm_before'),
                             ('norm2', 'layernorm_after'),
                             ('attn.proj', 'attention.output.dense'),
                             ('mlp.fc1', 'intermediate.dense'),
                             ('mlp.fc2', 'output.dense')]:
            sd[t + ours + '.weight'] = hf_sd[h + theirs + '.weight']
            sd[t + ours + '.bias'] = hf_sd[h + theirs + '.bias']
    return sd


def convnext_to_timm(hf_sd: Sd, arch: str) -> Sd:
    """transformers.ConvNextModel → timm ConvNeXt naming."""
    from video_features_torch.models.convnext import ARCHS
    depths = ARCHS[arch]['depths']
    sd = {
        'stem.0.weight': hf_sd['embeddings.patch_embeddings.weight'],
        'stem.0.bias': hf_sd['embeddings.patch_embeddings.bias'],
        'stem.1.weight': hf_sd['embeddings.layernorm.weight'],
        'stem.1.bias': hf_sd['embeddings.layernorm.bias'],
        'head.norm.weight': hf_sd['layernorm.weight'],
        'head.norm.bias': hf_sd['layernorm.bias'],
    }
    for s, depth in enumerate(depths):
        h, t = f'encoder.stages.{s}.', f'stages.{s}.'
        if s > 0:
            for idx in ('0', '1'):
                for p in ('weight', 'bias'):
                    sd[f'{t}downsample.{idx}.{p}'] = hf_sd[
                        f'{h}downsampling_layer.{idx}.{p}']
        for j in range(depth):
            hb, tb = f'{h}layers.{j}.', f'{t}blocks.{j}.'
            sd[tb + 'gamma'] = hf_sd[hb + 'layer_scale_parameter']
            for ours, theirs in [('conv_dw', 'dwconv'),
                                 ('norm', 'layernorm'),
                                 ('mlp.fc1', 'pwconv1'),
                                 ('mlp.fc2', 'pwconv2')]:
                sd[tb + ours + '.weight'] = hf_sd[hb + theirs + '.weight']
                sd[tb + ours + '.bias'] = hf_sd[hb + theirs + '.bias']
    return sd


def swin_to_timm(hf_sd: Sd, arch: str) -> Sd:
    """transformers.SwinModel → timm 0.9.12 Swin naming."""
    from video_features_torch.models.swin import ARCHS
    depths = ARCHS[arch]['depths']
    sd = {
        'patch_embed.proj.weight':
            hf_sd['embeddings.patch_embeddings.projection.weight'],
        'patch_embed.proj.bias':
            hf_sd['embeddings.patch_embeddings.projection.bias'],
        'patch_embed.norm.weight': hf_sd['embeddings.norm.weight'],
        'patch_embed.norm.bias': hf_sd['embeddings.norm.bias'],
        'norm.weight': hf_sd['layernorm.weight'],
        'norm.bias': hf_sd['layernorm.bias'],
    }
    for li, depth in enumerate(depths):
        if li > 0:   # HF stage li-1's tail merge == timm stage li's head
            for name in ('norm', 'reduction'):
                for p in ('weight', 'bias'):
                    key = f'encoder.layers.{li - 1}.downsample.{name}.{p}'
                    if key in hf_sd:   # reduction has no bias
                        sd[f'layers.{li}.downsample.{name}.{p}'] = hf_sd[key]
        for b in range(depth):
            h = f'encoder.layers.{li}.blocks.{b}.'
            t = f'layers.{li}.blocks.{b}.'
            sd[t + 'attn.relative_position_bias_table'] = hf_sd[
                h + 'attention.self.relative_position_bias_table']
            for p in ('weight', 'bias'):
                sd[t + f'attn.qkv.{p}'] = _cat0(
                    [hf_sd[h + f'attention.self.{proj}.{p}']
                     for proj in ('query', 'key', 'value')])
            for ours, theirs in [('norm1', 'layernorm_before'),
                                 ('norm2', 'layernorm_after'),
                                 ('attn.proj', 'attention.output.dense'),
                                 ('mlp.fc1', 'intermediate.dense'),
                                 ('mlp.fc2', 'output.dense')]:
                sd[t + ours + '.weight'] = hf_sd[h + theirs + '.weight']
                sd[t + ours + '.bias'] = hf_sd[h + theirs + '.bias']
    return sd


def regnet_to_timm(hf_sd: Sd, arch: str) -> Sd:
    """transformers.RegNetModel → timm RegNet naming. Handles both layer
    types the way the checkpoint dictates: 'y' blocks nest conv1/conv2/
    SE/conv3 as layer.0/1/2/3, SE-free 'x' blocks as layer.0/1/2."""
    from video_features_torch.models.regnet import ARCHS
    depths = ARCHS[arch][0]
    sd: Sd = {}

    def cna(t, h):
        sd[f'{t}.conv.weight'] = hf_sd[f'{h}.convolution.weight']
        for p in ('weight', 'bias', 'running_mean', 'running_var'):
            sd[f'{t}.bn.{p}'] = hf_sd[f'{h}.normalization.{p}']

    cna('stem', 'embedder.embedder')
    for si, depth in enumerate(depths):
        for j in range(depth):
            h = f'encoder.stages.{si}.layers.{j}'
            t = f's{si + 1}.b{j + 1}'
            cna(f'{t}.conv1', f'{h}.layer.0')
            cna(f'{t}.conv2', f'{h}.layer.1')
            has_se = f'{h}.layer.2.attention.0.weight' in hf_sd
            cna(f'{t}.conv3', f'{h}.layer.{3 if has_se else 2}')
            if has_se:
                for ours, theirs in [('fc1', 'attention.0'),
                                     ('fc2', 'attention.2')]:
                    for p in ('weight', 'bias'):
                        sd[f'{t}.se.{ours}.{p}'] = hf_sd[
                            f'{h}.layer.2.{theirs}.{p}']
            if f'{h}.shortcut.convolution.weight' in hf_sd:
                cna(f'{t}.downsample', f'{h}.shortcut')
    return sd


def clip_to_openai(hf_sd: Sd, arch: str = '') -> Sd:
    """transformers.CLIPModel → OpenAI CLIP state-dict naming (the layout
    ``models/clip.py`` loads).

    HF splits q/k/v where OpenAI fuses ``attn.in_proj_*``; HF's projection
    heads are F.linear weights (out, in) where OpenAI's ``visual.proj`` /
    ``text_projection`` are raw right-operands (in, out), transposed here.
    Load the result like an OpenAI checkpoint. ``arch`` is unused (the
    geometry is read off the keys); it is accepted so every converter
    has one signature."""
    del arch
    sd: Sd = {'logit_scale': hf_sd['logit_scale']}

    def block(dst: str, src: str) -> None:
        sd[f'{dst}.attn.in_proj_weight'] = _cat0(
            [hf_sd[f'{src}.self_attn.{p}_proj.weight'] for p in 'qkv'])
        sd[f'{dst}.attn.in_proj_bias'] = _cat0(
            [hf_sd[f'{src}.self_attn.{p}_proj.bias'] for p in 'qkv'])
        for ours, theirs in [('attn.out_proj', 'self_attn.out_proj'),
                             ('ln_1', 'layer_norm1'), ('ln_2', 'layer_norm2'),
                             ('mlp.c_fc', 'mlp.fc1'),
                             ('mlp.c_proj', 'mlp.fc2')]:
            for p in ('weight', 'bias'):
                sd[f'{dst}.{ours}.{p}'] = hf_sd[f'{src}.{theirs}.{p}']

    def depth(tower: str) -> int:
        return 1 + max(int(k.split('.')[3]) for k in hf_sd
                       if k.startswith(f'{tower}.encoder.layers.'))

    # visual tower (HF spells the pre-LN 'pre_layrnorm' historically)
    v = 'vision_model.'
    pre = v + ('pre_layrnorm' if v + 'pre_layrnorm.weight' in hf_sd
               else 'pre_layernorm')
    sd['visual.conv1.weight'] = hf_sd[v + 'embeddings.patch_embedding.weight']
    sd['visual.class_embedding'] = hf_sd[v + 'embeddings.class_embedding']
    sd['visual.positional_embedding'] = hf_sd[
        v + 'embeddings.position_embedding.weight']
    for p in ('weight', 'bias'):
        sd[f'visual.ln_pre.{p}'] = hf_sd[f'{pre}.{p}']
        sd[f'visual.ln_post.{p}'] = hf_sd[f'{v}post_layernorm.{p}']
    for i in range(depth('vision_model')):
        block(f'visual.transformer.resblocks.{i}', f'{v}encoder.layers.{i}')
    sd['visual.proj'] = _t2(hf_sd['visual_projection.weight'])

    # text tower
    t = 'text_model.'
    sd['token_embedding.weight'] = hf_sd[
        t + 'embeddings.token_embedding.weight']
    sd['positional_embedding'] = hf_sd[
        t + 'embeddings.position_embedding.weight']
    for p in ('weight', 'bias'):
        sd[f'ln_final.{p}'] = hf_sd[f'{t}final_layer_norm.{p}']
    for i in range(depth('text_model')):
        block(f'transformer.resblocks.{i}', f'{t}encoder.layers.{i}')
    sd['text_projection'] = _t2(hf_sd['text_projection.weight'])
    return sd


CONVERTERS = {
    'vit': vit_to_timm,
    'deit': deit_to_timm,
    'beit': beit_to_timm,
    'convnext': convnext_to_timm,
    'swin': swin_to_timm,
    'regnet': regnet_to_timm,
}


def hf_to_timm(family: str, hf_sd: Sd, arch: str) -> Sd:
    """Re-key a `transformers` state dict into timm naming for ``arch``.

    ``family`` is one of CONVERTERS; task-model prefixes (e.g.
    ``vit.encoder...`` from *ForImageClassification) are stripped first.
    """
    if family not in CONVERTERS:
        raise ValueError(
            f'hf-family {family!r} not supported: {sorted(CONVERTERS)}')
    return CONVERTERS[family](strip_task_prefix(hf_sd), arch)


def convert_file(src: str, dst: str, family: str, arch: str = '',
                 key: str = '') -> int:
    """Read a ``transformers`` state dict from ``src`` (``torch.load``;
    under ``key`` when given), re-key it for ``family``/``arch`` and
    write it to ``dst`` with ``torch.save``. Returns the tensor count."""
    import numpy as np
    import torch
    raw = torch.load(src, map_location='cpu', weights_only=True)
    if key:
        raw = raw[key]
    if family == 'clip':
        rekeyed = clip_to_openai(raw)
    else:
        rekeyed = hf_to_timm(family, raw, arch)
    out = {k: (v.detach().clone() if hasattr(v, 'detach')
               else torch.from_numpy(np.ascontiguousarray(v)))
           for k, v in rekeyed.items()}
    torch.save(out, dst)
    return len(out)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog='python -m video_features_torch.transplant.hf',
        description='Re-key a transformers checkpoint into the timm '
                    '(or OpenAI CLIP) layout the port loads.')
    ap.add_argument('src', help='the transformers state dict (.bin/.pt)')
    ap.add_argument('dst', help='the .pt to write')
    ap.add_argument('--hf-family', required=True,
                    choices=sorted(CONVERTERS) + ['clip'])
    ap.add_argument('--arch', default='',
                    help='the timm arch name whose layout to produce '
                         '(every family but clip)')
    ap.add_argument('--key', default='',
                    help='the key the state dict sits under in SRC')
    ns = ap.parse_args(argv)
    if ns.hf_family != 'clip' and not ns.arch:
        ap.error('--hf-family requires --arch (the timm name whose layout '
                 'to produce)')
    n = convert_file(ns.src, ns.dst, ns.hf_family, ns.arch, ns.key)
    # vft-lint: ok=stdout-purity — the converter command's summary line
    print(f'wrote {n} tensors to {ns.dst}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
