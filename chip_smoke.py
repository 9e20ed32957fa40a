#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (video_features_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100, CUDA
and nvcc. It imports only video_features_torch, torch, numpy, the
standard library, what the vggish phase's entry points import
(PyYAML in ``load_config``, scipy's Kaiser window for the 48 kHz
resample), and cv2 and PIL (phases 17 and 18 write their clips with
cv2, and the loaders and the decode farm's worker processes decode and
resize with them), and fails (non-zero exit, no result line) on any
phase that fails, and at once when no CUDA device is present or the
package is not beside it. Phases:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from ``video_features_torch/csrc``,
   one nvcc per source, all started together, with ptxas's register and
   spill lines, and the count of tensor-core (HGMMA) instructions in the
   GRU kernel's SASS (``cuobjdump -sass``), which must not be 0; beside
   them ``tools/gru_tf32x3_variants.py``'s ``pr14_one_pass`` (the one-pass
   design before the cluster kernel, phase 19 (a)'s yardstick);
3. kernels: each correlation-lookup kernel at the main path's shapes
   (h8=32, w8=43; N from 16, 128 and 8 frame pairs) and on an edge-case
   set (ragged N, a 13×9 grid whose top level is 1×1, windows all
   outside the map, which must be exact zeros, integer and edge
   coordinates) against its plain version and against the other kernel
   (max abs err ≤ 1e-5); at 128 pairs (the fused I3D path at batch 8,
   the record) and 8 pairs (the RAFT family at batch 8) its device time
   (from a CUDA graph of back-to-back calls, so the host's launch cost
   stays out, taking in turn enough seeded input sets that each call
   finds L2 cold), its plain version's time, its memory bound and share
   of it, a model of the 32-byte sectors its patch rows touch and the
   rate that makes at the measured time, and the time of
   ``F.grid_sample`` on the same samples as a
   yardstick, sampling prebuilt grids (``library_ms``) and, on a line of
   its own, building the grids from the coordinates inside the timed
   call; the GRU
   direction kernel, both axes, at (128, 32, 43) (the fused I3D path at
   batch 8), (8, 32, 43) (the RAFT family at batch 8), a ragged
   (3, 13, 9), a (2, 3, 4) smaller than the taps' halo and a (1, 6, 100)
   too wide for 128-pixel tiles on axis 'h', against its
   plain version (max abs err ≤ 1e-5), at the two full shapes both sides
   against a float64 plain version, with its time, its plain version's
   time, the two cuDNN convs' time (``library_ms``), its 3xTF32
   operations bound (``bound_ms``) and its fp32 FMA bound;
4. slice (I3D): ``ExtractI3D.extract_frames`` on 49 seeded 256×340
   frames at full width (both I3D towers at 224, stack 16, step 16,
   RAFT 20 iterations, batch 2: 3 windows, one padded tail) once per
   lookup kernel (the default masked kernel, and
   ``VFT_RAFT_LOOKUP=pallas``), each with the launch counts reset just
   before and read just after; output (3, 2048) and finite, a lookup
   launch per RAFT iteration and two GRU launches;
5. slice (RAFT family): ``ExtractRAFT.extract_frames`` on 33 seeded
   250×333 frames fed through the overlap batching (batch 8: 4 steps of
   8 pairs, padded to 256×336, RAFT 20 iterations), counts reset just
   before and read just after; output (32, 2, 250, 333), finite, 33
   timestamps, 80 lookup and 160 GRU launches;
6. kernel vs plain on the slices: the fused I3D step and a RAFT-family
   step with the kernels and with their plain versions (3 RAFT
   iterations), rel L2 ≤ 1e-3 per I3D stream and on the flow; then the
   fused step at batch 8 (20 iterations) timed both ways, in turns;
7. device resize: ``pil_resize_bilinear_device`` on the card byte-equal
   to the same function on the CPU, on seeded uint8 frames at six
   geometries (up, down, mixed, identity, 1080×1920 → 256×455), and its
   time for an (8, 17, 480, 640, 3) batch to 256×341 beside its bytes
   bound;
8. slice (R(2+1)D): ``ExtractR21D.extract_frames`` on 80 seeded 240×320
   frames (r2plus1d_18_16_kinetics, stack 16, batch 4: 5 windows, two
   steps, one padded tail), counts reset just before and read just
   after (no kernel lies on this path); output (5, 512) and finite; then
   one batch-4 step of r2plus1d_34_32_ig65m_ft_kinetics (stack 32);
9. slice (S3D): ``ExtractS3D.extract_frames`` on 128 seeded 256×340
   frames (2 stacks of 64 at batch 1; the long axis's given-scale grid
   differs from out/in there), counts as in 8; output (2, 1024), finite;
10. I3D with ``device_resize=true``: the I3D slice of phase 4 on 49
   seeded raw 480×640 frames, counts reset just before and read just
   after, against the same extractor with ``device_resize=false`` fed
   the frames resized by ``pil_resize_bilinear_device`` on the CPU: rel
   L2 ≤ 1e-6 per stream (the pixels are identical);
11. card vs CPU: the r21d and s3d steps (one stack-16 window each) on the
   card against the same function on the CPU, same seeded input and
   weights, rel L2 ≤ 1e-4 (cuDNN's TF32 default would give ~1e-3);
12. timing (CUDA events, warm-up excluded): ms per window of the r21d-18
   and r21d-34-32 steps at batch 4 and of the s3d step at batch 1 (one
   64-frame stack), each beside its fp32 FMA bound (the convolutions'
   2·out_elems·C_in·k, counted by ``FlopCounterMode``, over 67 TFLOP/s);
13. frame-wise (ResNet, CLIP): ``ExtractResNet.extract_frames`` (resnet50)
   and ``ExtractCLIP.extract_frames`` (ViT-B/32 at full width, 12 × 768,
   random weights) on 32 seeded host-transformed 224×224 frames, each at
   the config's batch 1 and at batch 32, counts reset just before and
   read just after every run (no kernel lies on these paths); outputs
   (32, 2048) and (32, 512), finite, 32 timestamps; CLIP's
   ``encode_text`` on 8 seeded token rows of the random init's reduced
   vocabulary (the BPE vocab is not on the card's host); each run's rows
   and the text tower on the card against the same functions on the CPU
   at the same batch, rel L2 ≤ 1e-4 (TF32 off); ms per frame at batch 1
   and 32 (CUDA events, 2 warm-ups, then steps covering 320 frames, at
   least 5) beside the fp32 FMA bound of all its convolutions and
   matmuls (``FlopCounterMode``, over 67 TFLOP/s), and the device's busy
   time per frame (the union of its activity intervals over 20 steps
   traced by ``torch.profiler``) as a share of that step time;
14. timm: ``ExtractTIMM.extract_frames`` with ViT-B/16 at full width
   (``vit_base_patch16_224``, 12 × 768, 197 tokens, random weights) on
   the same 32 frames at batch 1 and 32, then one full-width arch of
   every other family (distilled DeiT-B, ConvNeXt-T, Swin-T,
   EfficientNet-B0, RegNetY-800MF, MobileNetV3-L, BEiT-B, Mixer-B/16,
   and ResNet-50 under timm's recipe) at batch 8 on 8 of them, each as
   in 13: counts reset just before and read just after every run (no
   kernel lies on these paths), card vs CPU ≤ 1e-4, ms per frame beside
   the fp32 FMA bound, busy share;
15. timm long tokens: ViT-B/16 at ``image_size=768`` (48² + 1 = 2305
   tokens, past the 2048 at which attention runs blockwise) through
   ``extract_frames`` at batch 1 on 2 seeded 768×768 frames, counts
   reset just before and read just after, and each block's attention
   call counted by name (12 blockwise per frame, no dense); rows
   against the CPU ≤ 1e-4; ms per frame beside its bound; blockwise
   against dense attention on the card for the same seeded q, k, v
   (rel L2 ≤ 1e-5); the ms of both at 197 and 2305 tokens, beside
   ``F.scaled_dot_product_attention``'s, a reading the port never calls;
16. vggish: ``create_extractor(load_config('vggish', ...))`` and
   ``extract`` on a seeded 31 s 16 kHz wav (32 examples, one batch-32
   step; the stdlib ``wave`` reads it, so no decoder is needed), counts
   reset just before and read just after (none allowed); output (32,
   128) float32 against the same extractor on the CPU (rel L2 ≤ 1e-4),
   and with ``post_process`` and a seeded PCA file uint8 within 1 level
   of the CPU's (the share that differs printed); the VGG step's ms per
   example at batch 32 and 1 beside its fp32 FMA bound and busy share;
   the host DSP per clip at 16 and 48 kHz; ``extract``'s wall time. The
   native decoders need libav, which the card's host lacks: not
   exercised here, and said so;
17. streaming and packed loops: four seeded MJPG clips written with
   cv2 (256×340 of 49 and 33 frames, 240×320 of 81 and 17: 3, 2, 5 and
   1 windows), one I3D extractor from ``create_extractor(load_config(
   'i3d', ...))`` at full width (both towers, stack 16, step 16, RAFT 20
   iterations, batch 8, ``save_numpy``), after one warm-up run: (a) the
   per-video loop (``_extract`` per clip, ``decode_workers`` 2,
   ``inflight`` 2), (b) ``extract_packed`` at ``inflight`` 1 and (c) at
   2, each with its own output tree, the counts reset just before and
   read just after; fused steps counted (4, 2, 2) and the launches held
   to them (a lookup and two GRU launches per RAFT iteration); wall,
   windows/s and peak device memory; the device's busy share from a
   second, traced run of each; outputs (T, 2048), finite, T = 3, 2, 5,
   1; (b) and (c) byte-equal, (a) and (c) byte-equal or within rel L2
   1e-6 (the difference printed); then resnet50 at batch 32 on four
   240×320 clips per video at 1 and 4 decode threads (frames/s) and
   packed, 0 launches, the outputs equal the same way;
18. decode farm and fused worklists: the free space of ``/dev/shm`` and
   ``os.cpu_count()``, and a ``decode_farm_ring_mb`` that fits (the
   phase fails, naming the space found, when 4 rings of 10 MiB do not);
   a spawned process's boot as a farm worker pays it, stage by stage
   (the interpreter, the farm's imports, cv2 and PIL, the native
   decoder's build or load), failing if it imports torch or jax;
   (a) the I3D path of 17 from ``create_extractor(load_config('i3d',
   ...))`` with ``pack_across_videos=true`` at the YAML's
   ``decode_workers`` 2, then at 4, against 1, through
   ``extract_packed`` on 17's four clips (11 windows, 2 steps) and on one
   240×320 clip of 337 frames (21 windows, 3 steps), after a warm-up:
   counts reset just before and read just after each run (a lookup and
   two GRU launches per RAFT iteration), the farm's stats (started, every
   window shipped through the rings, 0 queue fallbacks, 0 respawns, the
   seconds of ``start()``), wall, windows/s, peak device memory; on the
   four clips a second run of each traced by ``torch.profiler`` (the
   busy share) and the stage tracer (the workers' decode and resize
   time, the copy out of shared memory, the rings' fill); outputs
   byte-equal across worker counts; (b) resnet50 and (c) CLIP ViT-B/32
   and ViT-B/16, all at batch 32, built by ``load_fused_configs`` and
   ``create_extractor``, on eight 240×320 clips of 96–103 frames, each
   packed alone and the three through ``run_packed_fused``, at
   ``decode_workers`` 1 and 4: frames/s, 0 launches, decode passes (8
   fused against 24 alone), the fused wall against the sum of the solo
   walls, every family's files byte-equal across all four runs; then no
   ring left in ``/dev/shm`` and no worker process alive;
19. precision lanes: (a) the one-pass GRU kernel (``passes=1``,
   ``gru_tf32_onepass``: clusters of CTAs sharing multicast weight
   tiles) with its cluster size, ring depth, tile, ptxas registers and
   spills, and its SASS HGMMA count (which must not be 0); against its
   plain version (the fp32 convolution of the TF32-rounded operands; max
   abs err ≤ 5e-4, mean ≤ 1e-6: a TF32 rounding of r·h may fall the
   other way after the sigmoid's last bit), float64 and the 3xTF32
   kernel (which must differ), both axes at (128, 32, 43) and (8, 32,
   43); its time and ``pr14_one_pass``'s in turns (old, new, new, old;
   the new one may not be slower), the bytes each pulls from L2 into
   shared memory and that rate, its plain version's time, the two cuDNN
   convs under TF32 (``library_ms``) and its bound (a third of
   3xTF32's); (b) the fused I3D
   path at the YAML's batch 8 (129 seeded frames, 8 windows, one step)
   and the RAFT family at batch 8 pairs, each from ``load_config`` and
   ``create_extractor`` under ``highest``, ``high`` (mixed's arithmetic:
   TF32 libraries, the GRU in 3xTF32) and ``tensorfloat32`` (the one-pass
   GRU), driven through ``extract_frames`` with the counts reset just
   before and read just after (one lookup and two GRU launches of the
   lane's pass count per iteration), ms per window or pair, peak memory,
   rel L2 against ``highest`` per I3D stream and per flow field; under
   ``tensorfloat32`` the RAFT step with the kernels against their plain
   versions (rel L2 ≤ 1e-3) and one traced fused step by kernel group;
   (c) resnet50, CLIP ViT-B/32, ViT-B/16 (at batch 1 and 32),
   r2plus1d_18 (batch 4), S3D (one 64-frame stack) and vggish (batch 32)
   under ``highest``, ``high`` and ``compute_dtype=bfloat16``, and (d)
   the first three under ``compute_dtype=int8``: rel L2 against the fp32
   lane (bf16 and int8 held to the JAX package's bounds), ms per item,
   peak memory, resident param bytes, no launches; (e)
   ``pil_resize_bilinear_device`` under ``tensorfloat32`` byte-equal to
   PIL; then ``registry.MIXED_FEATURES`` must be exactly the families
   whose drift under ``high`` is ≤ 1e-3, which load ``precision=mixed``,
   while the others refuse it naming ``precision``;
20. feature cache: phase 17's four clips and a byte copy of the first
   under another name, the I3D path of 17 from ``create_extractor(
   load_config('i3d', ...))`` with ``cache_enabled=true`` and a
   ``cache_l2_dir``, after a warm-up with the cache detached: (a) the
   per-video loop, a missing run (four fused steps with their launches,
   each video published to L1 and L2; the copy already a hit) and a run
   into a fresh ``output_path`` that is all hits, with no step and no
   launch, its files byte-identical; per-video wall of a miss and of a
   hit, the publish and lookup ms per video; (b) ``extract_packed`` at
   ``decode_workers`` 2 on a cold cache: the copy parks in the decode
   farm (``deduped`` ≥ 1, one decode fewer than the tasks) and every
   file is (a)'s bytes; (c) resnet50, CLIP ViT-B/32 and ViT-B/16 fused
   on fresh copies of the corpus over a cold cache: one ``hash_file``
   pass per file, and ``hash_file``'s MB/s; (d) a fresh L1 over (a)'s
   L2: every video a peer hit, no step, (a)'s bytes; (e) ``python -m
   video_features_torch.cache.gc --verify`` on (a)'s L1 exits 0, and 1
   after one stored file is truncated; the next run re-extracts that
   video alone (one step), byte-equal to (a). Every number is printed
   with the card's name and power limit. No ring or worker is left.
21. flight recorder: phase 17's four clips through the I3D path of 17
   from ``create_extractor(load_config('i3d', ...))``: (a) per video
   with ``trace_out``, ``manifest_out``, ``postmortem_dir`` and
   ``profile_dir`` (the run inside ``torch_profiler_trace``, as the CLI
   runs it) in a cold build directory, against the same run without
   them: byte-identical outputs; a valid trace (monotonic timestamps,
   every key in the JAX package's trace-event set, every stage span's
   name in ``STAGES``) with one ``saved`` ``video`` span per clip under
   one trace id; the manifest's outcomes, its ``model`` and ``d2h``
   stages and its ``compile`` section naming one ``nvcc`` build of each
   kernel source with its seconds; (b) the ``torch.profiler`` trace's
   ``masked_kernel``, ``gru_tf32x3`` and ``gru_tf32_onepass`` events
   against the launch counters (two kernels per GRU direction); (c) ``extract_packed`` at
   the YAML's 2 farm workers with ``trace_out`` and ``manifest_out``:
   ``decode`` spans on two worker pid lanes inside the run's window, the
   manifest's ``farm`` naming 2 workers, (a)'s bytes, no ring or worker
   left; (d) I3D per video with ``trace_out`` and ``manifest_out`` on
   and off, in turns, 3 runs each (corpus wall and ms per window), a
   warm build directory's ``compile`` of ``{}``, and the µs of one
   ``SpanRecorder.span`` append and of ``Tracer.stage`` with and without
   a recorder. Every number is printed with the card's name and power
   limit.

22. several processes and devices, on phase 17's four clips through the
   I3D path at the YAML's width (stack 16, step 16, RAFT 20 iterations,
   batch 8): (a) ``multihost``: two CLI processes (``multihost=true
   coordinator_address=127.0.0.1:<free port> num_processes=2
   process_id=r``, gloo) on the one card, each process's wall printed:
   disjoint interleaved shards, both exit 0 after the barrier, every
   output byte-equal to a one-process run; (b) the mesh knobs:
   ``mesh_devices=0`` resolves to ``torch.cuda.device_count()`` and runs
   packed, ``mesh_devices`` one over the count raises naming the counts,
   ``data_parallel=true`` gives a mesh of every card, byte-equal to the
   plain run; (c) two shards on the one card (``make_mesh(devices=[cuda:0,
   cuda:0])``, ``use_mesh``): packed I3D at 8 per shard and packed resnet50
   at 32, byte-equal to one device, the lookup and GRU counters holding
   both shards' launches; (d) ``sequence_parallel``: ViT-B/16 at image_size
   768 (2305 tokens) through the extractor on a one-card ring, and a
   two-shard ring on the one card, against the blockwise path (rel L2 ≤
   1e-5), the max abs error and the times beside the blockwise path's;
   (e) with two cards or more, ``data_parallel`` I3D over two cards
   byte-equal to one card; with one card a line saying it was not run.
   The phase prints its own wall time.

23. serve (fused I3D): (a) an in-process ``ExtractionServer`` with the
   fused I3D configuration at full width (both towers at 224, stack 16,
   step 16, RAFT 20 iterations, batch 8, seeded random weights, the
   card) answers three requests on three seeded clips written as phase
   17 writes them, over its loopback socket through ``ServeClient``: two
   clips (cold: the extractor is built), the same two into a fresh
   ``output_path`` (warm) and one clip with a path that does not exist;
   the counts reset just before and read just after each request (a
   lookup and two GRU launches per RAFT iteration of every step); one
   extractor build, requests 1 and 2 byte-equal, the missing path
   failed alone; the per-video loop on the same clips and weights
   against them (rel L2 ≤ 1e-6); (b) the cold and the warm request's
   wall; a sustained stream: 24 seeded clips (phase 17's four shapes six
   times over, 66 windows) sent as 24 one-clip requests at once, twice,
   and the per-video loop on the same corpus twice, in the order server,
   loop, loop, server, each round's launches counted from 0 and its
   windows/s over the whole round; the requests' latencies; the outputs
   of both server rounds and a loop round against each other (rel L2 ≤
   1e-6); the device's busy share over a third, traced server round;
   each line with the card's name and power limit; (c) with
   ``watchdog_stall_s=30``, ``slo_latency_p99_s=60`` and
   ``slo_availability=0.99``: no stall, a filled ``slo`` section, and
   the ``vft_serve_*``, ``vft_slo_*`` families in ``metrics_prom``; (d)
   ``python -m video_features_torch serve`` in a subprocess with
   ``trace_out``, once without and once with ``serve_prewarm=i3d``: the
   time to its endpoint line and its first (cold) request's wall, one
   request from ``ServeClient``, then SIGTERM: exit 0, the drained line,
   a merged trace whose spans cover the request, no ring left in
   ``/dev/shm`` and no child process alive.

The line before the last is the kernels' JSON record (``launches``: the
sum over the path runs of phases 4, 5, 10, 17, 18, 19, 20, 21, 22 and
23; the one-pass GRU instantiation is an entry of its own); the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_ATOL = 1e-5      # fp reassociation of a 4-term blend of O(1) values
# the one-pass GRU kernel against its plain version: the products agree
# exactly, but r·h, the q GEMM's input, is rounded to TF32 after a
# sigmoid whose last bit may differ between the two (expf vs torch's), and
# a rounding that falls the other way moves that input by one TF32 ulp
# (2^-11 relative): with weights of ~0.05 and a few such flips in an
# output's 640 inputs, up to a few 1e-4; rare, so the mean stays at fp32
# reassociation's level
GRU1_ATOL, GRU1_MEAN_ATOL = 5e-4, 1e-6
# the one-pass kernel may not be slower than pr14_one_pass (the mean of
# its two turns against the mean of the old kernel's two, in one call)
ONE_PASS_SLOWER = 1.0
SLICE_REL_L2 = 1e-3     # the BASELINE feature bar, kernel vs plain end to end
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 rate
FP32_FLOP_PER_S = 67e12     # H100 SXM published fp32 (non-tensor) rate
TF32_FLOP_PER_S = 495e12    # H100 SXM published dense TF32 tensor-core rate
H8, W8 = 32, 43             # RAFT's /8 grid at the 256×344 padded geometry
STACK, FRAMES, FRAME_HW = 16, 49, (256, 340)
SLICE_BATCH, SLICE_ITERS, CHECK_ITERS = 2, 20, 3
# the GRU direction's pixel grids: the fused I3D path at batch 8 (128
# pairs), the RAFT family at batch 8, a ragged one, one smaller than the
# taps' halo (taps leave both edges of every row and column), and one too
# wide for 128-pixel tiles on axis 'h' (64-pixel tiles, tap windows staged
# apart)
GRU_SHAPES = ((128, H8, W8), (8, H8, W8), (3, 13, 9), (2, 3, 4),
              (1, 6, 100))
# the RAFT family slice: 33 frames → 4 steps of 8 pairs, padded to 256×336
RAFT_FRAMES, RAFT_HW, RAFT_BATCH, RAFT_FPS = 33, (250, 333), 8, 25.0
# the lookup kernels' pair counts on the (H8, W8) grid: a check-only size,
# the fused I3D path at batch 8 (the record) and the RAFT family at batch 8
LOOKUP_PAIRS = (16, 128, 8)
LOOKUP_EDGE_CASES = ((3, 13, 9, 'mixed'), (1, 31, 41, 'mixed'),
                     (2, H8, W8, 'far'), (2, H8, W8, 'edges'),
                     (3, 13, 9, 'edges'))
KERNELS = ('corr_lookup', 'gru_direction')
# device resize: the JAX package's test geometries plus a 1080p frame,
# and the timed batch (raw 480×640 frames of 8 windows of 17)
RESIZE_GEOMETRIES = ((240, 320, 256, 341), (360, 480, 256, 341),
                     (123, 77, 45, 200), (256, 344, 256, 344),
                     (100, 100, 256, 256), (1080, 1920, 256, 455))
RESIZE_TIMED = ((8, STACK + 1, 480, 640, 3), (256, 341))
RAW_HW = (480, 640)
DEVICE_RESIZE_REL_L2 = 1e-6
CARD_CPU_REL_L2 = 1e-4      # cuDNN's TF32 default gives ~1e-3
R21D_HW, R21D_WINDOWS, R21D_BATCH = (240, 320), 5, 4
S3D_HW, S3D_STACK, S3D_STACKS = (256, 340), 64, 2
# the frame-wise families: 32 host-transformed frames at the config's
# batch 1 and at batch 32, on the card and on the CPU; each step time
# covers TIMED_FRAMES frames, the device's busy share BUSY_STEPS steps
FRAMEWISE_FRAMES, FRAMEWISE_HW, FRAMEWISE_BATCHES = 32, 224, (1, 32)
FRAMEWISE_FPS, TEXT_ROWS, TIMED_FRAMES, BUSY_STEPS = 25.0, 8, 320, 20
# the timm slice: ViT-B/16 at full width on those frames at batch 1 and
# 32; one full-width arch of every other family at batch 8 on 8 of them;
# ViT-B/16 at image_size 768 (48² + 1 = 2305 tokens: blockwise attention)
# at batch 1 on 2 seeded 768×768 frames
TIMM_VIT = 'vit_base_patch16_224'
TIMM_FAMILIES = ('deit_base_distilled_patch16_224', 'convnext_tiny',
                 'swin_tiny_patch4_window7_224', 'efficientnet_b0',
                 'regnety_008', 'mobilenetv3_large_100',
                 'beit_base_patch16_224', 'mixer_b16_224', 'resnet50')
TIMM_FAMILY_BATCH, TIMM_LONG_SIZE, TIMM_LONG_FRAMES = 8, 768, 2
BLOCKWISE_REL_L2 = 1e-5     # the online softmax's reassociation
# vggish: a seeded 31 s 16 kHz wav is exactly 32 examples of 0.96 s, one
# step at the config's batch 32; the host DSP is also timed at 48 kHz
# (resampy's kaiser_best resample to 16 kHz)
VGGISH_SECONDS, VGGISH_SR, VGGISH_RESAMPLED_SR = 31.0, 16000, 48000
VGGISH_EXAMPLES, VGGISH_BATCHES = 32, (32, 1)
# the streaming loop and the packed loop: four seeded MJPG clips (frames,
# height, width) written with cv2, giving 3, 2, 5 and 1 windows of 17 at
# step 16; the two geometries pool apart (5 and 6 windows), so the packed
# loop runs 2 steps at batch 8 where the per-video loop runs 4
PACK_CLIPS = ((49, 256, 340), (33, 256, 340), (81, 240, 320), (17, 240, 320))
PACK_WINDOWS, PACK_BATCH, PACK_FPS = (3, 2, 5, 1), 8, 25.0
PACK_REL_L2 = 1e-6
# resnet50 through both loops at batch 32 on four short 240×320 clips
PACK_RESNET_CLIPS = ((40, 240, 320), (25, 240, 320), (50, 240, 320),
                     (17, 240, 320))
PACK_RESNET_BATCH, PACK_RESNET_WORKERS = 32, (1, 4)
# the decode farm: the fused I3D path packed at the i3d YAML's
# decode_workers (2) and at 4, against 1, on phase 17's four clips and on
# one 240×320 clip of 337 frames (21 windows, 3 steps at batch 8); then
# resnet50, CLIP ViT-B/32 and ViT-B/16 at batch 32 on eight 240×320 clips
# of ~100 frames, each packed alone and the three fused, at 1 and 4
FARM_WORKERS = (1, 2, 4)
FARM_SHORT_STEPS = 2
FARM_LONG_CLIP = ((337, 240, 320),)
FARM_LONG_WINDOWS, FARM_LONG_STEPS = 21, 3
FARM_FRAME_CLIPS = tuple((96 + i, 240, 320) for i in range(8))
FARM_FRAME_WORKERS = (1, 4)
FARM_FAMILIES = {'resnet': 'resnet50', 'clip': 'ViT-B/32',
                 'timm': 'vit_base_patch16_224'}
# an i3d window (17 × 256 × 341 × 3 uint8, 4.45 MB) must take the ring,
# which ships windows of up to half its size
FARM_MIN_RING_MB = 10
# the precision lanes: highest (the reference), high (mixed's arithmetic:
# TF32 in cuDNN and cuBLAS, the GRU kernel in 3xTF32; mixed itself is
# refused outside registry.MIXED_FEATURES) and tensorfloat32 (the one-pass
# GRU kernel); the fused I3D step at the YAML's batch 8 (129 frames: 8
# windows, one step) and the RAFT family at batch 8 pairs; mixed is
# admitted for a family whose drift against highest is at most MIXED_BAR
LANE_PRECISIONS = ('highest', 'high', 'tensorfloat32')
LANE_BATCH, LANE_I3D_FRAMES, LANE_RAFT_BATCH = 8, 8 * STACK + 1, 8
MIXED_BAR = 1e-3
# the bf16 families at their config batch (the frame-wise ones at 32 too):
# (family, label, overrides, batches, seeded input of a batch)
LANE_FAMILIES = (
    ('resnet', 'resnet50', {'model_name': 'resnet50'}, (1, 32),
     lambda np, b: rand_frames(np, 80, (b, 224, 224, 3))),
    ('clip', 'CLIP ViT-B/32', {'model_name': 'ViT-B/32'}, (1, 32),
     lambda np, b: rand_frames(np, 80, (b, 224, 224, 3))),
    ('timm', 'ViT-B/16', {'model_name': 'vit_base_patch16_224'}, (1, 32),
     lambda np, b: rand_frames(np, 80, (b, 224, 224, 3))),
    ('r21d', 'r2plus1d_18', {}, (4,),
     lambda np, b: rand_frames(np, 81, (b, 16, 240, 320, 3))),
    ('s3d', 's3d', {}, (1,),
     lambda np, b: rand_frames(np, 82, (b, 64, 256, 340, 3))),
    ('vggish', 'vggish', {}, (32,),
     lambda np, b: (np.random.RandomState(83).rand(b, 1, 96, 64) * 7
                    - 4.6).astype(np.float32)),
)


def fail(msg: str) -> None:
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> float:
    print(f'== {name}', flush=True)
    return time.perf_counter()


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fns, reps: int, replays: int = 5) -> float:
    """Mean device time of one call from a CUDA graph of ``reps``
    back-to-back calls, replayed ``replays`` times: the host's launch cost,
    which at the RAFT family's sizes exceeds a lookup kernel's own time,
    stays out. ``fns`` holds one callable per input set; the calls take
    them in turn, and each call's output lives until its set comes round
    again, so that sets which together exceed L2 (``lookup_sets``) leave
    every call its inputs and output cold, as on the path, where the
    update block's convolutions run between two lookups."""
    reps = -(-reps // len(fns)) * len(fns)
    for fn in fns:                # warm-up, and the kernels' one-time set-up
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    keep = [None] * len(fns)
    with torch.cuda.graph(graph):
        for i in range(reps):
            keep[i % len(fns)] = fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph, keep
    return ms


def lookup_sets(torch, n: int) -> int:
    """Input sets for ``graph_ms`` at N pixels: enough that their outputs
    alone (N·324·4 bytes each) fill the card's L2 four times over."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(1, math.ceil(4 * l2 / (n * 324 * 4)))


def window_sectors(torch, coords, shapes, pad_levels: bool) -> int:
    """32-byte sectors that the patch rows touch, levels based at 256-byte
    aligned addresses: the in-map part of each pixel's 10 rows per level
    (the padded kernel: all 10 rows of its padded level). A model, not a
    measurement, of what the reads cost at the memory's granularity,
    beside the cells of the bound."""
    n = coords.shape[0]
    pixel = torch.arange(n, device=coords.device)[:, None]
    r = torch.arange(10, device=coords.device)[None, :]
    total = 0
    for i, (h, w) in enumerate(shapes):
        c = coords / (2.0 ** i)
        x0 = torch.floor(c[:, 0].clamp(-6.0, w + 5.0)).long() - 4
        y0 = torch.floor(c[:, 1].clamp(-6.0, h + 5.0)).long() - 4
        if pad_levels:
            stride, plane = w + 22, (h + 22) * (w + 22)
            lo, hi = x0 + 11, x0 + 21
            rows = y0[:, None] + 11 + r
            keep = torch.ones_like(rows, dtype=torch.bool)
        else:
            stride, plane = w, h * w
            lo, hi = x0.clamp(min=0), (x0 + 10).clamp(max=w)
            rows = y0[:, None] + r
            keep = (rows >= 0) & (rows < h) & (hi > lo)[:, None]
        row0 = pixel * plane + rows * stride
        first = (row0 + lo[:, None]) * 4 // 32
        last = ((row0 + hi[:, None]) * 4 - 1) // 32
        total += int((last - first + 1)[keep].sum().item())
    return total


def window_cells(torch, coords, shapes, pad_levels: bool) -> int:
    """Level cells the lookup must read for these coords: the in-map
    part of each pixel's 10×10 patch per level (the padded kernel reads
    the whole patch of its padded level)."""
    side = 10
    total = 0
    for i, (h, w) in enumerate(shapes):
        if pad_levels:
            total += coords.shape[0] * side * side
            continue
        c = coords / (2.0 ** i)
        x0 = torch.floor(c[:, 0].clamp(-6.0, w + 5.0)) - 4
        y0 = torch.floor(c[:, 1].clamp(-6.0, h + 5.0)) - 4
        cols = ((x0 + side).clamp(max=w) - x0.clamp(min=0)).clamp(min=0)
        rows = ((y0 + side).clamp(max=h) - y0.clamp(min=0)).clamp(min=0)
        total += int((cols * rows).sum().item())
    return total


def bound_ms(n: int, cells: int) -> tuple:
    """(ms, 'bytes' | 'operations'): coords read + patch cells read +
    (N, 324) written, against 9 flops per output."""
    nbytes = n * 2 * 4 + cells * 4 + n * 324 * 4
    flops = n * 324 * 9
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def grid_sample_grids(torch, levels, coords):
    """The (N, 9, 9, 2) sampling grid per level, normalised for
    ``grid_sample(align_corners=True)``, output order [n, i(x), j(y)]."""
    d = torch.arange(-4, 5, device=coords.device, dtype=torch.float32)
    grids = []
    for i, lvl in enumerate(levels):
        h, w = lvl.shape[1:]
        c = coords / (2.0 ** i)
        x = c[:, 0, None, None] + d[None, :, None]        # [n, i(x), j]
        y = c[:, 1, None, None] + d[None, None, :]        # [n, i, j(y)]
        x, y = torch.broadcast_tensors(x, y)
        grids.append(torch.stack([2 * x / (w - 1) - 1, 2 * y / (h - 1) - 1], -1))
    return grids


def grid_sample_lookup(torch, F, levels, coords):
    """The same samples through ``F.grid_sample(align_corners=True,
    padding_mode='zeros')``, a yardstick the port never calls: ``(sample,
    full)``, where ``sample`` samples prebuilt grids (``library_ms``) and
    ``full`` also builds the grids from the coordinates, as a caller
    whose coordinates change every iteration must."""
    def sample(grids):
        return torch.cat([
            F.grid_sample(lvl.unsqueeze(1), g, mode='bilinear',
                          padding_mode='zeros', align_corners=True
                          ).reshape(lvl.shape[0], 81)
            for lvl, g in zip(levels, grids)], dim=-1)
    grids = grid_sample_grids(torch, levels, coords)
    return (lambda: sample(grids),
            lambda: sample(grid_sample_grids(torch, levels, coords)))


def lookup_inputs(torch, gen, pairs: int, h: int, w: int, kind: str = 'mixed'):
    """Seeded levels (N, h/2ⁱ, w/2ⁱ) and (pairs, h, w, 2) coordinates of
    one kind: 'mixed' in-range, fractional and far out-of-range centroids
    plus integers; 'far' ones at least 1000 px outside every level;
    'edges' integers, with each level's first and last row and column and
    the ones just outside them."""
    n = pairs * h * w
    levels = [torch.randn(n, max(h >> i, 1), max(w >> i, 1), device='cuda',
                          generator=gen) for i in range(4)]

    def rand(*s):
        return torch.rand(*s, device='cuda', generator=gen)
    if kind == 'mixed':
        xy = rand(pairs, h, w, 2) * torch.tensor([w + 18.0, h + 18.0],
                                                 device='cuda') - 9.0
        far = rand(pairs, h, w, 1) < 0.05
        xy = torch.where(far, xy * 1000.0, xy)
        ints = rand(pairs, h, w, 1) < 0.05
        xy = torch.where(ints, torch.round(xy), xy)
    elif kind == 'far':
        sign = torch.where(rand(pairs, h, w, 2) < 0.5, -1.0, 1.0)
        xy = sign * (1e3 + rand(pairs, h, w, 2) * 1e6)
    else:
        axes = []
        for extent in (w, h):
            picks = list(range(-6, extent + 6))
            for level in range(4):
                last = max(extent >> level, 1)
                picks += [s << level for s in (-1, 0, last - 1, last)]
            picks = torch.tensor(picks, device='cuda', dtype=torch.float32)
            axes.append(picks[torch.randint(len(picks), (pairs, h, w),
                                            device='cuda', generator=gen)])
        xy = torch.stack(axes, -1)
    return levels, xy.contiguous()


def check_lookups(torch, corr_lookup, levels, coords, where: str) -> dict:
    """Both kernels against their plain versions and each other; fails
    past KERNEL_ATOL. Returns the max abs errors."""
    padded = corr_lookup.pad_pyramid(levels)
    masked = corr_lookup.lookup_corr_lanes(levels, coords)
    unmasked = corr_lookup.lookup_corr(padded, coords)
    torch.cuda.synchronize()
    errs = {'masked': (masked - corr_lookup.lookup_corr_lanes_plain(
                levels, coords)).abs().max().item(),
            'padded': (unmasked - corr_lookup.lookup_corr_plain(
                padded, coords)).abs().max().item()}
    cross = (masked - unmasked).abs().max().item()
    print(f'{where}: max abs err masked={errs["masked"]:.3e} '
          f'padded={errs["padded"]:.3e} masked-vs-padded={cross:.3e}', flush=True)
    if max(errs.values()) > KERNEL_ATOL or cross > KERNEL_ATOL:
        fail(f'lookup kernel disagrees with its plain version at {where}')
    return errs


def kernel_phase(torch, F, corr_lookup):
    """Each kernel vs its plain version and vs the other kernel at the
    main path's shapes and on the edge cases; times at the fused I3D
    path's batch 8 (128 pairs, the record) and the RAFT family's batch 8
    (8 pairs), each beside its bound and ``F.grid_sample``."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    rec = {'masked': {'err': 0.0}, 'padded': {'err': 0.0}}

    def note(errs):
        for key, err in errs.items():
            rec[key]['err'] = max(rec[key]['err'], err)
    # edge cases: ragged N against the kernels' 8-pixel groups (351, 1271),
    # a 13×9 grid whose top level is 1×1, windows all outside the map,
    # integer and edge coordinates
    for pairs, h, w, kind in LOOKUP_EDGE_CASES:
        levels, coords = lookup_inputs(torch, gen, pairs, h, w, kind)
        note(check_lookups(torch, corr_lookup, levels, coords,
                           f'edge case {pairs}x{h}x{w} {kind}'))
        if kind == 'far':
            got = (corr_lookup.lookup_corr_lanes(levels, coords).abs().max().item(),
                   corr_lookup.lookup_corr(corr_lookup.pad_pyramid(levels),
                                           coords).abs().max().item())
            if got != (0.0, 0.0):
                fail(f'windows outside the map are not exact zeros: {got}')
    for pairs in LOOKUP_PAIRS:
        n = pairs * H8 * W8
        if pairs == LOOKUP_PAIRS[0]:
            levels, coords = lookup_inputs(torch, gen, pairs, H8, W8)
            note(check_lookups(torch, corr_lookup, levels, coords,
                               f'pairs={pairs} N={n}'))
            continue
        # seeded input sets, timed in turn so that each call finds L2 cold;
        # set 0 is checked against the plain versions
        sets = []
        for _ in range(lookup_sets(torch, n)):
            levels, coords = lookup_inputs(torch, gen, pairs, H8, W8)
            flat = coords.reshape(-1, 2)
            sample, full = grid_sample_lookup(torch, F, levels, flat)
            sets.append({'levels': levels, 'coords': coords, 'flat': flat,
                         'padded': corr_lookup.pad_pyramid(levels),
                         'sample': sample, 'full': full})
        s0 = sets[0]
        note(check_lookups(torch, corr_lookup, s0['levels'], s0['coords'],
                           f'pairs={pairs} N={n}'))
        lib_err = (s0['sample']().reshape(s0['coords'].shape[:3] + (324,))
                   - corr_lookup.lookup_corr_lanes(s0['levels'], s0['coords'])
                   ).abs().max().item()

        def calls(make):
            return [functools.partial(make, st) for st in sets]
        # device time from CUDA graphs (graph_ms), the same way for all
        at = {'masked': {'ms': graph_ms(torch, calls(
                  lambda st: corr_lookup.lookup_corr_lanes(st['levels'],
                                                           st['coords'])), 50)},
              'padded': {'ms': graph_ms(torch, calls(
                  lambda st: corr_lookup.lookup_corr(st['padded'],
                                                     st['coords'])), 50)}}
        at['masked']['plain_ms'] = graph_ms(torch, calls(
            lambda st: corr_lookup.lookup_corr_lanes_plain(st['levels'],
                                                           st['coords'])), 3, 2)
        at['padded']['plain_ms'] = graph_ms(torch, calls(
            lambda st: corr_lookup.lookup_corr_plain(st['padded'],
                                                     st['coords'])), 3, 2)
        lib_ms = graph_ms(torch, calls(lambda st: st['sample']()), 10)
        lib_full_ms = graph_ms(torch, calls(lambda st: st['full']()), 10)
        print(f'lookups at N={n}: timed over {len(sets)} input set(s) in '
              f'turn ({len(sets) * n * 324 * 4 / 1e6:.1f} MB of outputs against '
              f'{torch.cuda.get_device_properties(0).L2_cache_size / 1e6:.1f} MB '
              f'of L2)', flush=True)
        print(f'grid_sample at N={n}: {lib_ms:.4f} ms sampling prebuilt grids, '
              f'{lib_full_ms:.4f} ms with the grids built from the coordinates '
              f'in the call; max abs diff vs masked kernel {lib_err:.3e}',
              flush=True)
        shapes = [lvl.shape[1:] for lvl in s0['levels']]
        for key, pad_levels in (('masked', False), ('padded', True)):
            r = at[key]
            # this run's inputs, per call: the mean over the sets
            cells = sum(window_cells(torch, st['flat'], shapes, pad_levels)
                        for st in sets) / len(sets)
            r['bound_ms'], r['bound_by'] = bound_ms(n, cells)
            r['library_ms'] = lib_ms
            print(f'{key} kernel at N={n}: {r["ms"]:.4f} ms, plain '
                  f'{r["plain_ms"]:.4f} ms, bound {r["bound_ms"]:.4f} ms '
                  f'({r["bound_by"]}), {r["bound_ms"] / r["ms"]:.1%} of the '
                  f'bound, grid_sample {lib_ms:.4f} ms ({lib_ms / r["ms"]:.2f}x '
                  f'the kernel)', flush=True)
            sectors = sum(window_sectors(torch, st['flat'], shapes, pad_levels)
                          for st in sets) / len(sets)
            moved = sectors * 32 + n * (2 + 324) * 4
            print(f'{key} kernel at N={n} (model, not a measurement): patch '
                  f'rows touch {sectors:.0f} sectors '
                  f'({sectors * 32 / 1e6:.1f} MB, {sectors * 32 / (cells * 4):.2f}x '
                  f'the cells\' bytes); with coords and output '
                  f'{moved / 1e6:.1f} MB, which at the measured time is '
                  f'{moved / r["ms"] / 1e9:.2f} TB/s '
                  f'({moved / r["ms"] / 1e9 / (HBM_BYTES_PER_S / 1e12):.1%} of '
                  f'{HBM_BYTES_PER_S / 1e12:.2f} TB/s)', flush=True)
            if pairs == LOOKUP_PAIRS[1]:
                rec[key].update(r)
        del sets, s0
    torch.cuda.empty_cache()
    return rec


def gru_bound_ms(m: int) -> dict:
    """Least times in ms for one GRU direction over m pixels: 'bytes' (h,
    motion, zr_term, q_term and the weights read once, the new h written
    once), 'tf32x3' (the kernel's 3 TF32 tensor-core products per fp32
    product of 2·5·256·384 flops a pixel) and 'fp32' (the same flops at
    the fp32 FMA rate)."""
    nbytes = m * (128 + 128 + 256 + 128 + 128) * 4 + 5 * 256 * 384 * 4
    flops = 2 * m * 5 * 256 * 384
    return {'bytes': nbytes / HBM_BYTES_PER_S * 1e3,
            'tf32x3': 3 * flops / TF32_FLOP_PER_S * 1e3,
            'fp32': flops / FP32_FLOP_PER_S * 1e3}


def gru_phase(torch, gru):
    """The GRU direction kernel vs its plain version, both axes, at
    GRU_SHAPES; at the two full shapes both sides against a float64 plain
    version, and times: the kernel, its plain version (weights unpacked,
    two cuDNN convs, TF32 off), and the two convs alone from prebuilt conv
    weights (the library yardstick), beside the bounds."""
    gen = torch.Generator(device='cuda').manual_seed(1)

    def randn(*s):
        return torch.randn(*s, device='cuda', generator=gen)
    rec = {'err': 0.0, 'at': {}}
    for shape in GRU_SHAPES:
        x = (torch.tanh(randn(*shape, 128)), randn(*shape, 128),
             *gru.pack_direction(0.05 * randn(256, 256, 1, 5),
                                 0.05 * randn(128, 256, 1, 5)),
             0.1 * randn(*shape, 256), 0.1 * randn(*shape, 128))
        full = shape in GRU_SHAPES[:2]
        for axis in gru.AXES:
            got = gru.gru_direction(*x, axis)
            torch.cuda.synchronize()
            plain = gru.gru_direction_plain(*x, axis)
            err = (got - plain).abs().max().item()
            line = f'gru {shape} axis {axis}: max abs err {err:.3e}'
            if full:
                # who carries the error: both sides against a float64 plain
                ref = gru.gru_direction_plain(*[t.double() for t in x], axis)
                line += (f' (vs float64: kernel '
                         f'{(got - ref).abs().max().item():.3e}, plain '
                         f'{(plain - ref).abs().max().item():.3e})')
                del ref
            print(line, flush=True)
            rec['err'] = max(rec['err'], err)
            if err > KERNEL_ATOL:
                fail(f'GRU kernel disagrees with its plain version at '
                     f'{shape} axis {axis}: {err}')
            if not full:
                continue
            m = shape[0] * shape[1] * shape[2]
            convs = [gru._conv_weight(gru.unpack_direction(w), axis)
                     for w in x[2:4]]
            ms = cuda_ms(torch, lambda: gru.gru_direction(*x, axis), 10)
            plain_ms = cuda_ms(torch, lambda: gru.gru_direction_plain(*x, axis), 5)
            lib_ms = cuda_ms(torch, lambda: gru.gru_direction_convs(
                x[0], x[1], *convs, x[4], x[5], axis), 5)
            b = gru_bound_ms(m)
            rec['at'][(shape, axis)] = (ms, plain_ms, lib_ms, b)
            print(f'gru {shape} axis {axis} (M={m}): {ms:.4f} ms, plain '
                  f'{plain_ms:.4f} ms, cuDNN convs {lib_ms:.4f} ms; bound '
                  f'{b["tf32x3"]:.4f} ms (operations, 3xTF32 at '
                  f'{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s), {b["tf32x3"] / ms:.1%} '
                  f'of it; fp32 FMA bound {b["fp32"]:.4f} ms '
                  f'({b["fp32"] / ms:.1%}); bytes bound {b["bytes"]:.4f} ms',
                  flush=True)
        del x
    torch.cuda.empty_cache()
    # the record: the fused I3D path's batch-8 shape, mean of the two axes
    at = [rec['at'][(GRU_SHAPES[0], a)] for a in gru.AXES]
    rec['ms'] = sum(a[0] for a in at) / len(at)
    rec['plain_ms'] = sum(a[1] for a in at) / len(at)
    rec['library_ms'] = sum(a[2] for a in at) / len(at)
    rec['bound_ms'], rec['bound_by'] = at[0][3]['tf32x3'], 'operations'
    rec['fp32_bound_ms'] = at[0][3]['fp32']
    return rec


def sass_counts(path: Path, opcode: str) -> dict:
    """Instructions whose opcode starts with ``opcode``, per function of
    the built library's SASS (``cuobjdump -sass``)."""
    tool = shutil.which('cuobjdump') or str(
        Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'cuobjdump')
    out = subprocess.run([tool, '-sass', str(path)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail(f'cuobjdump -sass {path.name} failed: {out.stderr.strip()}')
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if 'Function :' in line:
            fn = line.split('Function :', 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and f' {opcode}' in line and '/*' in line:
            counts[fn] += 1
    return counts


def sass_count(path: Path, opcode: str) -> int:
    """Instructions whose opcode starts with ``opcode`` in the built
    library's SASS (``cuobjdump -sass``)."""
    return sum(sass_counts(path, opcode).values())


def slice_frames(np):
    """49 seeded uint8 frames, 256×340×3."""
    rng = np.random.RandomState(0)
    return rng.randint(0, 256, (FRAMES, *FRAME_HW, 3)).astype(np.uint8)


def reset_counts(corr_lookup, gru) -> None:
    corr_lookup.lookup_corr_lanes.launches = 0
    corr_lookup.lookup_corr.launches = 0
    gru.gru_direction.launches = 0
    for passes in gru.gru_direction.launches_by_passes:
        gru.gru_direction.launches_by_passes[passes] = 0


def read_counts(corr_lookup, gru) -> dict:
    """Launches by kernel: 'gru' the GRU kernel in 3xTF32, 'gru1' its
    one-pass instantiation."""
    by_passes = gru.gru_direction.launches_by_passes
    return {'masked': corr_lookup.lookup_corr_lanes.launches,
            'padded': corr_lookup.lookup_corr.launches,
            'gru': by_passes[3], 'gru1': by_passes[1]}


def slice_phase(torch, np, ex, corr_lookup, gru, lookup_env: str):
    """Drive extract_frames once to warm up, then once with the counts
    reset just before and read just after."""
    os.environ['VFT_RAFT_LOOKUP'] = lookup_env
    frames = slice_frames(np)
    # the loader protocol: (frames, times, indices) batches
    batches = [(list(frames[i:i + 16]), None, None) for i in range(0, FRAMES, 16)]
    ex.extract_frames(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(corr_lookup, gru)
    t0 = time.perf_counter()
    feats = ex.extract_frames(batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(corr_lookup, gru)
    out = ex._maybe_concat_streams(feats)['rgb']
    windows = (FRAMES - (STACK + 1)) // STACK + 1
    print(f'VFT_RAFT_LOOKUP={lookup_env}: features {out.shape}, '
          f'{wall / windows * 1e3:.1f} ms per window (wall, batch '
          f'{SLICE_BATCH}), launches {counts}, peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB', flush=True)
    if out.shape != (windows, 2048) or not np.isfinite(out).all():
        fail(f'slice output {out.shape} (want ({windows}, 2048)) or not finite')
    return counts


def raft_frames(np):
    """33 seeded uint8 frames, 250×333×3."""
    rng = np.random.RandomState(1)
    return rng.randint(0, 256, (RAFT_FRAMES, *RAFT_HW, 3)).astype(np.uint8)


def raft_slice_phase(torch, np, ex, batch_frames, corr_lookup, gru):
    """ExtractRAFT.extract_frames through the overlap batching: once to
    warm up, then once with the counts reset just before and read just
    after."""
    frames = raft_frames(np)

    def run():
        batches = batch_frames(iter(frames), RAFT_BATCH + 1, RAFT_FPS, overlap=1)
        return ex.extract_frames(batches, RAFT_FPS, frame_hw=RAFT_HW)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(corr_lookup, gru)
    t0 = time.perf_counter()
    feats = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(corr_lookup, gru)
    flow, stamps = feats['raft'], feats['timestamps_ms']
    pairs = RAFT_FRAMES - 1
    print(f'raft family: flow {flow.shape}, {len(stamps)} timestamps, '
          f'{wall / pairs * 1e3:.2f} ms per frame pair (wall, batch '
          f'{RAFT_BATCH}, {SLICE_ITERS} iterations), launches {counts}, peak '
          f'device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB',
          flush=True)
    if flow.shape != (pairs, 2, *RAFT_HW) or not np.isfinite(flow).all():
        fail(f'raft family output {flow.shape} (want ({pairs}, 2, '
             f'{RAFT_HW[0]}, {RAFT_HW[1]})) or not finite')
    if len(stamps) != RAFT_FRAMES or float(feats['fps']) != RAFT_FPS:
        fail(f'raft family: {len(stamps)} timestamps (want {RAFT_FRAMES}), '
             f'fps {feats["fps"]}')
    return counts


def rel_l2(k, p) -> float:
    k, p = k.double(), p.double()
    return ((k - p).norm() / p.norm()).item()


def plain_phase(torch, np, ex, fused_two_stream_step, pad_amounts):
    """The fused step with the kernels and with their plain versions."""
    frames = slice_frames(np)
    stacks = np.stack([frames[:STACK + 1], frames[STACK:2 * STACK + 1]])
    pads = pad_amounts(*FRAME_HW)
    x = torch.from_numpy(stacks).cuda()
    with torch.inference_mode():
        outs = [fused_two_stream_step(ex.params, x, pads, ('rgb', 'flow'),
                                      raft_iters=CHECK_ITERS, plain_kernels=plain)
                for plain in (False, True)]
    for s in ('rgb', 'flow'):
        rel = rel_l2(outs[0][s], outs[1][s])
        print(f'{os.environ["VFT_RAFT_LOOKUP"]}: {s} stream kernels vs plain '
              f'rel L2 {rel:.3e} ({CHECK_ITERS} RAFT iterations)', flush=True)
        if not rel <= SLICE_REL_L2:
            fail(f'{s} stream: kernels vs plain rel L2 {rel} > {SLICE_REL_L2}')


def raft_plain_phase(torch, np, ex, raft_model):
    """One RAFT-family step (8 pairs) with the kernels and with their
    plain versions."""
    x = torch.from_numpy(raft_frames(np)[:RAFT_BATCH + 1]).cuda()
    padded, _ = raft_model.pad_to_multiple(x)
    with torch.inference_mode():
        outs = [raft_model.forward_consecutive(ex.params, padded,
                                               iters=CHECK_ITERS,
                                               plain_kernels=plain)
                for plain in (False, True)]
    rel = rel_l2(*outs)
    print(f'raft family: flow kernels vs plain rel L2 {rel:.3e} '
          f'({CHECK_ITERS} RAFT iterations)', flush=True)
    if not rel <= SLICE_REL_L2:
        fail(f'raft family flow: kernels vs plain rel L2 {rel} > {SLICE_REL_L2}')


def step_timing(torch, np, ex, fused_two_stream_step, pad_amounts):
    """The fused step at batch 8 (RAFT 20 iterations), kernels vs plain
    versions, in turns (plain, kernels, kernels, plain): ms per window."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randint(0, 256, (8, STACK + 1, *FRAME_HW, 3)
                                     ).astype(np.uint8)).cuda()
    pads = pad_amounts(*FRAME_HW)

    def ms_per_window(plain):
        with torch.inference_mode():
            return cuda_ms(torch, lambda: fused_two_stream_step(
                ex.params, x, pads, ('rgb', 'flow'), raft_iters=SLICE_ITERS,
                plain_kernels=plain), reps=1, warmup=1) / 8
    times = {False: [], True: []}
    for plain in (True, False, False, True):
        times[plain].append(ms_per_window(plain))
    print(f'fused step at batch 8, {SLICE_ITERS} iterations: kernels '
          f'{times[False][0]:.2f} / {times[False][1]:.2f} ms per window, plain '
          f'versions {times[True][0]:.2f} / {times[True][1]:.2f} ms per window',
          flush=True)


def rand_frames(np, seed: int, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def frame_batches(frames, size: int = 16):
    """The loader protocol: (frames, times, indices) batches."""
    return [(list(frames[i:i + size]), None, None)
            for i in range(0, len(frames), size)]


def resize_phase(torch, np, transforms) -> None:
    """``pil_resize_bilinear_device`` on the card byte-equal to the CPU
    at RESIZE_GEOMETRIES; its time on RESIZE_TIMED."""
    for i, (h, w, oh, ow) in enumerate(RESIZE_GEOMETRIES):
        x = torch.from_numpy(rand_frames(np, 10 + i, (2, 3, h, w, 3)))
        cpu = transforms.pil_resize_bilinear_device(x, (oh, ow))
        card = transforms.pil_resize_bilinear_device(x.cuda(), (oh, ow)).cpu()
        same = cpu.shape == (2, 3, oh, ow, 3) and torch.equal(cpu, card)
        print(f'device resize {h}x{w} -> {oh}x{ow}: card '
              f'{"byte-equal to" if same else "DIFFERS from"} the CPU', flush=True)
        if not same:
            fail(f'pil_resize_bilinear_device on the card differs from the CPU '
                 f'at {h}x{w} -> {oh}x{ow}')
    shape, size = RESIZE_TIMED
    x = torch.from_numpy(rand_frames(np, 16, shape)).cuda()
    ms = cuda_ms(torch, lambda: transforms.pil_resize_bilinear_device(x, size), 10)
    nbytes = x.numel() + x.numel() // (shape[2] * shape[3]) * size[0] * size[1]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f'device resize {shape} -> {size}: {ms:.4f} ms, bytes bound '
          f'{bound:.4f} ms ({bound / ms:.1%} of it)', flush=True)


def check_no_launches(counts, where: str) -> None:
    if any(counts.values()):
        fail(f'{where}: kernels launched on a path that has none: {counts}')


def r21d_phase(torch, np, ExtractR21D, corr_lookup, gru):
    """ExtractR21D.extract_frames at full width, counts reset just before
    and read just after; then one r2plus1d_34_32 step."""
    def extractor(model_name):
        return ExtractR21D({
            'feature_type': 'r21d', 'model_name': model_name,
            'batch_size': R21D_BATCH, 'device': 'cuda', 'precision': 'highest',
            'allow_random_weights': True, 'on_extraction': 'save_numpy',
            'output_path': str(ROOT / 'output')})
    ex = extractor('r2plus1d_18_16_kinetics')
    batches = frame_batches(rand_frames(np, 4, (R21D_WINDOWS * 16, *R21D_HW, 3)))
    ex.extract_frames(batches)
    torch.cuda.synchronize()
    reset_counts(corr_lookup, gru)
    t0 = time.perf_counter()
    feats = ex.extract_frames(batches)['r21d']
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(corr_lookup, gru)
    print(f'r21d (r2plus1d_18_16_kinetics): features {feats.shape}, '
          f'{wall / R21D_WINDOWS * 1e3:.1f} ms per window (wall, batch '
          f'{R21D_BATCH}), launches {counts}', flush=True)
    check_no_launches(counts, 'r21d slice')
    if feats.shape != (R21D_WINDOWS, 512) or not np.isfinite(feats).all():
        fail(f'r21d output {feats.shape} (want ({R21D_WINDOWS}, 512)) or not finite')
    ex34 = extractor('r2plus1d_34_32_ig65m_ft_kinetics')
    out = ex34.step(rand_frames(np, 5, (R21D_BATCH, 32, *R21D_HW, 3)))
    print(f'r21d (r2plus1d_34_32_ig65m_ft_kinetics): one batch-{R21D_BATCH} '
          f'step, features {out.shape}', flush=True)
    if out.shape != (R21D_BATCH, 512) or not np.isfinite(out).all():
        fail(f'r21d-34 output {out.shape} (want ({R21D_BATCH}, 512)) or not finite')
    return ex, ex34


def s3d_phase(torch, np, ExtractS3D, corr_lookup, gru):
    """ExtractS3D.extract_frames on S3D_STACKS 64-frame stacks at batch 1,
    counts reset just before and read just after."""
    ex = ExtractS3D({
        'feature_type': 's3d', 'stack_size': S3D_STACK, 'step_size': S3D_STACK,
        'batch_size': 1, 'device': 'cuda', 'precision': 'highest',
        'allow_random_weights': True, 'on_extraction': 'save_numpy',
        'output_path': str(ROOT / 'output')})
    batches = frame_batches(rand_frames(np, 6, (S3D_STACKS * S3D_STACK, *S3D_HW, 3)))
    ex.extract_frames(batches)
    torch.cuda.synchronize()
    reset_counts(corr_lookup, gru)
    t0 = time.perf_counter()
    feats = ex.extract_frames(batches)['s3d']
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(corr_lookup, gru)
    print(f's3d: features {feats.shape}, {wall / S3D_STACKS * 1e3:.1f} ms per '
          f'64-frame stack (wall, batch 1), launches {counts}', flush=True)
    check_no_launches(counts, 's3d slice')
    if feats.shape != (S3D_STACKS, 1024) or not np.isfinite(feats).all():
        fail(f's3d output {feats.shape} (want ({S3D_STACKS}, 1024)) or not finite')
    return ex


def device_resize_phase(torch, np, ex, transforms, corr_lookup, gru):
    """The I3D slice on raw frames with device_resize=true (counts reset
    just before and read just after) against device_resize=false on the
    frames resized on the CPU."""
    from video_features_torch.ops.host_transforms import pil_edge_resize_geometry
    raw = rand_frames(np, 7, (FRAMES, *RAW_HW, 3))
    resized = transforms.pil_resize_bilinear_device(
        torch.from_numpy(raw), pil_edge_resize_geometry(*RAW_HW, 256)).numpy()

    def run(frames, device_resize):
        ex.device_resize = device_resize
        return ex._maybe_concat_streams(ex.extract_frames(frame_batches(frames)))['rgb']
    torch.cuda.synchronize()
    reset_counts(corr_lookup, gru)
    got = run(raw, True)
    torch.cuda.synchronize()
    counts = read_counts(corr_lookup, gru)
    ref = run(resized, False)
    windows = (FRAMES - (STACK + 1)) // STACK + 1
    if got.shape != (windows, 2048) or not np.isfinite(got).all():
        fail(f'device_resize output {got.shape} (want ({windows}, 2048)) or not finite')
    for name, cols in (('rgb', slice(0, 1024)), ('flow', slice(1024, 2048))):
        rel = rel_l2(torch.from_numpy(got[:, cols]), torch.from_numpy(ref[:, cols]))
        print(f'device_resize=true on raw {RAW_HW[0]}x{RAW_HW[1]} frames: {name} '
              f'stream vs host-resized frames rel L2 {rel:.3e}', flush=True)
        if not rel <= DEVICE_RESIZE_REL_L2:
            fail(f'device_resize {name} stream rel L2 {rel} > {DEVICE_RESIZE_REL_L2}')
    print(f'device_resize=true: launches {counts}', flush=True)
    return counts


def card_vs_cpu_phase(torch, np, r21d_ex, s3d_ex):
    """The r21d and s3d steps on the card against the CPU, one stack-16
    window each, same input and weights."""
    from video_features_torch.extract.r21d import r21d_step
    from video_features_torch.extract.s3d import s3d_step
    from video_features_torch.transplant import to_device
    for name, step, params, hw in (
            ('r21d', functools.partial(r21d_step, arch='r2plus1d_18'),
             r21d_ex.params, R21D_HW),
            ('s3d', s3d_step, s3d_ex.params, S3D_HW)):
        x = torch.from_numpy(rand_frames(np, 8, (1, 16, *hw, 3)))
        with torch.inference_mode():
            card = step(params, x.cuda()).cpu()
            host = step(to_device(params, 'cpu'), x)
        rel = rel_l2(card, host)
        print(f'{name} step, card vs CPU: rel L2 {rel:.3e}', flush=True)
        if not rel <= CARD_CPU_REL_L2:
            fail(f'{name}: card vs CPU rel L2 {rel} > {CARD_CPU_REL_L2} (TF32 on?)')


def counted_flops(torch, fn, op_filter: str = '') -> int:
    """The flops ``FlopCounterMode`` counts in one call (convolutions at
    2·out_elems·C_in·k, matmuls at 2·M·N·K) of the ops whose name holds
    ``op_filter``; '' keeps every counted op."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return sum(n for op, n in counter.get_flop_counts()['Global'].items()
               if op_filter in str(op))


def union_ms(spans) -> float:
    """Length of the union of (start_us, end_us) intervals, in ms."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def busy_ms(torch, fn, steps: int):
    """The device's busy time per call of ``fn`` over ``steps`` traced
    calls: the union of its kernel and copy intervals (``torch.profiler``),
    or None when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if str(getattr(ev, 'device_type', '')).endswith('CUDA')]
    return union_ms(spans) / steps if spans else None


def family_timing(torch, np, r21d_ex, r21d34_ex, s3d_ex) -> None:
    """ms per window of the r21d and s3d steps on device-resident uint8
    stacks, beside the fp32 FMA bound of their convolutions."""
    from video_features_torch.extract.r21d import r21d_step
    from video_features_torch.extract.s3d import s3d_step
    cases = (
        ('r21d r2plus1d_18 (stack 16)', R21D_BATCH, functools.partial(
            r21d_step, r21d_ex.params, arch='r2plus1d_18'), (16, *R21D_HW)),
        ('r21d r2plus1d_34 (stack 32)', R21D_BATCH, functools.partial(
            r21d_step, r21d34_ex.params, arch='r2plus1d_34'), (32, *R21D_HW)),
        ('s3d (stack 64)', 1, functools.partial(s3d_step, s3d_ex.params),
         (S3D_STACK, *S3D_HW)))
    for i, (name, batch, step, shape) in enumerate(cases):
        x = torch.from_numpy(rand_frames(np, 20 + i, (batch, *shape, 3))).cuda()
        with torch.inference_mode():
            ms = cuda_ms(torch, lambda: step(x), reps=5) / batch
            flops = counted_flops(torch, lambda: step(x), 'convolution') / batch
        bound = flops / FP32_FLOP_PER_S * 1e3
        print(f'{name} step at batch {batch}: {ms:.3f} ms per window; fp32 FMA '
              f'bound {bound:.3f} ms ({flops / 1e9:.1f} GFLOP of convolutions '
              f'per window), {bound / ms:.1%} of it', flush=True)


def framewise_runs(torch, np, name, ex, step, dim, frames, batches_of,
                   corr_lookup, gru) -> None:
    """One frame-wise extractor: ``extract_frames`` over ``frames`` at
    each batch of ``batches_of`` (counts reset just before and read just
    after each run, none allowed), each run's rows against ``step`` on
    the CPU at the same batch, and per batch ms per frame (CUDA events
    over TIMED_FRAMES frames, at least 5 steps) beside the fp32 FMA bound
    of all its convolutions and matmuls, and the device's busy share over
    BUSY_STEPS traced steps."""
    from video_features_torch.transplant import to_device
    n = len(frames)
    times = [i / FRAMEWISE_FPS * 1000 for i in range(n)]
    feats = {}
    for batch in batches_of:
        batches = [(list(frames[i:i + batch]), times[i:i + batch], None)
                   for i in range(0, n, batch)]
        ex.extract_frames(batches[:1], FRAMEWISE_FPS)       # warm-up
        torch.cuda.synchronize()
        reset_counts(corr_lookup, gru)
        t0 = time.perf_counter()
        out = ex.extract_frames(batches, FRAMEWISE_FPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(corr_lookup, gru)
        rows = out[ex.feature_type]
        print(f'{name}: extract_frames at batch {batch}: features '
              f'{rows.shape}, {wall / n * 1e3:.2f} ms per frame (wall), '
              f'launches {counts}', flush=True)
        check_no_launches(counts, f'{name} at batch {batch}')
        if rows.shape != (n, dim) or not np.isfinite(rows).all() \
                or len(out['timestamps_ms']) != n:
            fail(f'{name} output {rows.shape} (want ({n}, {dim})), '
                 f'{len(out["timestamps_ms"])} timestamps, or not finite')
        feats[batch] = rows
    host_params = to_device(ex.params, 'cpu')
    for batch in batches_of:
        with torch.inference_mode():
            host = torch.cat([step(host_params, torch.from_numpy(frames[i:i + batch]))
                              for i in range(0, n, batch)])
        rel = rel_l2(torch.from_numpy(feats[batch]), host)
        print(f'{name} at batch {batch}, card vs CPU ({n} frames): '
              f'rel L2 {rel:.3e}', flush=True)
        if not rel <= CARD_CPU_REL_L2:
            fail(f'{name} at batch {batch}: card vs CPU rel L2 {rel} > '
                 f'{CARD_CPU_REL_L2} (TF32 on?)')
    del host_params
    for batch in batches_of:
        xb = torch.from_numpy(frames[:batch]).cuda()
        reps = max(5, TIMED_FRAMES // batch)
        with torch.inference_mode():
            ms = cuda_ms(torch, lambda: step(ex.params, xb), reps=reps) / batch
            flops = counted_flops(torch, lambda: step(ex.params, xb)) / batch
            busy = busy_ms(torch, lambda: step(ex.params, xb), BUSY_STEPS)
        bound = flops / FP32_FLOP_PER_S * 1e3
        print(f'{name} step at batch {batch}: {ms:.4f} ms per frame over {reps} '
              f'steps; fp32 FMA bound {bound:.4f} ms ({flops / 1e9:.2f} GFLOP of '
              f'convolutions and matmuls per frame), {bound / ms:.1%} of it',
              flush=True)
        if busy is None:
            print(f'{name} at batch {batch}: device busy share not measured '
                  '(the profiler recorded no device activity)', flush=True)
        else:
            print(f'{name} at batch {batch}: device busy {busy / batch:.4f} ms '
                  f'per frame over {BUSY_STEPS} traced steps, '
                  f'{busy / batch / ms:.1%} of the untraced step time',
                  flush=True)


def framewise_common() -> dict:
    return {'device': 'cuda', 'precision': 'highest', 'batch_size': 1,
            'allow_random_weights': True, 'on_extraction': 'save_numpy',
            'output_path': str(ROOT / 'output')}


def framewise_phase(torch, np, corr_lookup, gru) -> None:
    """resnet50 and CLIP ViT-B/32 through extract_frames at batch 1 and
    32 (counts reset just before and read just after each run), CLIP's
    text tower, card vs CPU, and ms per frame beside the fp32 FMA bound."""
    from video_features_torch.extract.clip import ExtractCLIP, clip_step
    from video_features_torch.extract.resnet import ExtractResNet, resnet_step
    from video_features_torch.models import clip as clip_model
    from video_features_torch.transplant import to_device
    frames = rand_frames(np, 30, (FRAMEWISE_FRAMES, FRAMEWISE_HW, FRAMEWISE_HW, 3))
    common = framewise_common()
    ex = ExtractResNet({'feature_type': 'resnet', 'model_name': 'resnet50', **common})
    framewise_runs(torch, np, 'resnet50', ex,
                   functools.partial(resnet_step, arch='resnet50'), 2048, frames,
                   FRAMEWISE_BATCHES, corr_lookup, gru)
    ex = ExtractCLIP({'feature_type': 'clip', 'model_name': 'ViT-B/32', **common})
    framewise_runs(torch, np, 'CLIP ViT-B/32', ex,
                   functools.partial(clip_step, arch=ex.arch), 512, frames,
                   FRAMEWISE_BATCHES, corr_lookup, gru)
    rng = np.random.RandomState(31)
    tokens = np.zeros((TEXT_ROWS, 77), np.int64)
    for r in range(TEXT_ROWS):
        n = rng.randint(1, 30)
        tokens[r, :n] = rng.randint(1, 510, n)
        tokens[r, n] = 511          # end of text: the row's largest id
    tokens = torch.from_numpy(tokens)
    with torch.inference_mode():
        txt = clip_model.encode_text(ex.params, tokens.cuda()).cpu()
        ref = clip_model.encode_text(to_device(ex.params, 'cpu'), tokens)
    rel = rel_l2(txt, ref)
    print(f'CLIP ViT-B/32 encode_text on {TEXT_ROWS} seeded token rows: '
          f'{tuple(txt.shape)}, card vs CPU rel L2 {rel:.3e}', flush=True)
    if txt.shape != (TEXT_ROWS, 512) or not torch.isfinite(txt).all() \
            or not rel <= CARD_CPU_REL_L2:
        fail(f'CLIP encode_text: {tuple(txt.shape)}, rel L2 {rel}')
    torch.cuda.empty_cache()


def timm_extractor(model_name: str, **overrides):
    from video_features_torch.extract.timm import ExtractTIMM
    return ExtractTIMM({'feature_type': 'timm', 'model_name': model_name,
                        **framewise_common(), **overrides})


def timm_step_of(ex):
    from video_features_torch.extract.timm import timm_step
    return functools.partial(timm_step, family=ex.family, arch=ex.arch,
                             mean=ex.data_cfg['mean'], std=ex.data_cfg['std'])


def timm_phase(torch, np, corr_lookup, gru) -> None:
    """ViT-B/16 at full width on the frame-wise phase's 32 frames at batch
    1 and 32, then one full-width arch of every other timm family at
    batch TIMM_FAMILY_BATCH on the first 8 of them (``framewise_runs``)."""
    frames = rand_frames(np, 30, (FRAMEWISE_FRAMES, FRAMEWISE_HW, FRAMEWISE_HW, 3))
    ex = timm_extractor(TIMM_VIT)
    framewise_runs(torch, np, f'timm {TIMM_VIT}', ex, timm_step_of(ex), ex.feat_dim,
                   frames, FRAMEWISE_BATCHES, corr_lookup, gru)
    del ex
    for name in TIMM_FAMILIES:
        ex = timm_extractor(name)
        framewise_runs(torch, np, f'timm {name} ({ex.family})', ex,
                       timm_step_of(ex), ex.feat_dim,
                       frames[:TIMM_FAMILY_BATCH], (TIMM_FAMILY_BATCH,),
                       corr_lookup, gru)
        del ex
        torch.cuda.empty_cache()


def attention_qkv(torch, tokens: int, seed: int):
    """Seeded (1, tokens, 12, 64) q, k, v on the card: ViT-B/16's heads."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    return [torch.randn(1, tokens, 12, 64, device='cuda', generator=gen)
            for _ in range(3)]


def timm_long_phase(torch, np, F, corr_lookup, gru) -> None:
    """ViT-B/16 at image_size TIMM_LONG_SIZE (2305 tokens: blockwise
    attention in every block) through extract_frames at batch 1, counts
    reset just before and read just after, the attention calls counted
    by name; its rows against the CPU; blockwise against dense attention
    on the card; and the attention's ms at 197 and 2305 tokens, beside
    ``F.scaled_dot_product_attention``'s (a reading; the port never calls
    it)."""
    from video_features_torch.ops import attention
    from video_features_torch.models import vit as vit_model
    ex = timm_extractor(TIMM_VIT, image_size=TIMM_LONG_SIZE)
    step = timm_step_of(ex)
    tokens = (TIMM_LONG_SIZE // 16) ** 2 + 1
    frames = rand_frames(np, 40, (TIMM_LONG_FRAMES, TIMM_LONG_SIZE, TIMM_LONG_SIZE, 3))
    times = [i / FRAMEWISE_FPS * 1000 for i in range(TIMM_LONG_FRAMES)]
    batches = [([f], [t], None) for f, t in zip(frames, times)]
    ex.extract_frames(batches[:1], FRAMEWISE_FPS)            # warm-up
    calls = {'dense_attention': 0, 'blockwise_attention': 0}
    originals = {key: getattr(attention, key) for key in calls}

    def counted(key):
        def call(*args, **kwargs):
            calls[key] += 1
            return originals[key](*args, **kwargs)
        return call
    torch.cuda.synchronize()
    reset_counts(corr_lookup, gru)
    try:
        for key in calls:
            setattr(attention, key, counted(key))
        t0 = time.perf_counter()
        out = ex.extract_frames(batches, FRAMEWISE_FPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for key, fn in originals.items():
            setattr(attention, key, fn)
    counts = read_counts(corr_lookup, gru)
    rows = out['timm']
    layers = vit_model.ARCHS[TIMM_VIT]['layers']
    print(f'timm {TIMM_VIT} at image_size {TIMM_LONG_SIZE} ({tokens} tokens): '
          f'features {rows.shape}, {wall / TIMM_LONG_FRAMES * 1e3:.2f} ms per '
          f'frame (wall, batch 1), attention calls {calls}, launches {counts}',
          flush=True)
    check_no_launches(counts, f'timm {TIMM_VIT} at image_size {TIMM_LONG_SIZE}')
    if rows.shape != (TIMM_LONG_FRAMES, ex.feat_dim) or not np.isfinite(rows).all():
        fail(f'timm long-token output {rows.shape} or not finite')
    if calls != {'dense_attention': 0,
                 'blockwise_attention': layers * TIMM_LONG_FRAMES}:
        fail(f'timm at {tokens} tokens did not attend blockwise in every '
             f'block: {calls}')
    from video_features_torch.transplant import to_device
    with torch.inference_mode():
        host = torch.cat([step(to_device(ex.params, 'cpu'), torch.from_numpy(f[None]))
                          for f in frames])
    rel = rel_l2(torch.from_numpy(rows), host)
    print(f'timm {TIMM_VIT} at {tokens} tokens, card vs CPU: rel L2 {rel:.3e}',
          flush=True)
    if not rel <= CARD_CPU_REL_L2:
        fail(f'timm long-token card vs CPU rel L2 {rel} > {CARD_CPU_REL_L2}')
    xb = torch.from_numpy(frames[:1]).cuda()
    with torch.inference_mode():
        ms = cuda_ms(torch, lambda: step(ex.params, xb), reps=10)
        flops = counted_flops(torch, lambda: step(ex.params, xb))
    bound = flops / FP32_FLOP_PER_S * 1e3
    print(f'timm {TIMM_VIT} step at {tokens} tokens, batch 1: {ms:.4f} ms per '
          f'frame; fp32 FMA bound {bound:.4f} ms ({flops / 1e9:.2f} GFLOP), '
          f'{bound / ms:.1%} of it', flush=True)
    del ex, xb
    torch.cuda.empty_cache()
    with torch.inference_mode():
        q, k, v = attention_qkv(torch, tokens, 43)
        dense = attention.dense_attention(q, k, v)
        blocked = attention.blockwise_attention(q, k, v, block_size=vit_model._BLOCK)
        rel = rel_l2(blocked, dense)
        print(f'blockwise vs dense attention on the card at {tokens} tokens: '
              f'rel L2 {rel:.3e}, max abs {(blocked - dense).abs().max().item():.3e}',
              flush=True)
        if not rel <= BLOCKWISE_REL_L2:
            fail(f'blockwise attention vs dense rel L2 {rel} > {BLOCKWISE_REL_L2}')
        for n in (197, tokens):
            q, k, v = attention_qkv(torch, n, n)
            path = 'blockwise' if n >= vit_model.BLOCKWISE_THRESHOLD else 'dense'
            dense_ms = cuda_ms(torch, lambda: attention.dense_attention(q, k, v), 20)
            block_ms = cuda_ms(torch, lambda: attention.blockwise_attention(
                q, k, v, block_size=vit_model._BLOCK), 20)
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh), 20)
            sdpa_rel = rel_l2(F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2),
                              attention.dense_attention(q, k, v))
            print(f'attention (1, {n}, 12, 64) on the card: dense {dense_ms:.4f} ms, '
                  f'blockwise {block_ms:.4f} ms (the path runs {path}); '
                  f'F.scaled_dot_product_attention {sdpa_ms:.4f} ms, rel L2 '
                  f'{sdpa_rel:.3e} vs dense (a reading; not on the path)',
                  flush=True)
    torch.cuda.empty_cache()


def write_seeded_wav(np, path: Path, seconds: float, sr: int, seed: int) -> str:
    """Mono int16 noise plus two tones, written with the stdlib's wave."""
    import wave
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1234 * t) \
        + 0.1 * rng.randn(len(t))
    with wave.open(str(path), 'wb') as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(x, -1, 1) * 32767).astype('<i2').tobytes())
    return str(path)


def vggish_phase(torch, np, corr_lookup, gru) -> None:
    """The vggish family through its entry points (``load_config``,
    ``create_extractor``, ``extract``) on a seeded 31 s wav: on the card,
    counts reset just before and read just after (none allowed), against
    the same extractor on the CPU, plain and with ``post_process``; then
    the VGG step's ms per example at batch 32 and 1 beside its fp32 FMA
    bound and busy share, the host DSP at 16 and 48 kHz, and the whole
    ``extract``."""
    from video_features_torch.config import load_config
    from video_features_torch.io import native
    from video_features_torch.ops.audio import waveform_to_examples
    from video_features_torch.registry import create_extractor
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav = write_seeded_wav(np, tmp / 'clip.wav', VGGISH_SECONDS, VGGISH_SR, 50)
        rng = np.random.RandomState(51)
        pca = tmp / 'pca.npz'
        np.savez(pca, pca_eigen_vectors=rng.randn(128, 128) * 0.3,
                 pca_means=rng.rand(128, 1) * 0.5)

        def extractor(device, **extra):
            return create_extractor(load_config('vggish', {
                'video_paths': wav, 'device': device, 'allow_random_weights': True,
                'on_extraction': 'save_numpy', 'output_path': str(tmp / 'out'),
                'tmp_path': str(tmp / 'tmp'), **extra}))
        outs, walls = {}, {}
        for name, extra in (('plain', {}),
                            ('post_process', {'post_process': True,
                                              'pca_params_path': str(pca)})):
            ex = extractor('cuda', **extra)
            ex.extract(wav)                                   # warm-up
            torch.cuda.synchronize()
            reset_counts(corr_lookup, gru)
            t0 = time.perf_counter()
            out = ex.extract(wav)['vggish']
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            counts = read_counts(corr_lookup, gru)
            print(f'vggish ({name}): extract() of the {VGGISH_SECONDS:g} s wav: '
                  f'{out.shape} {out.dtype}, {walls[name] * 1e3:.2f} ms (wall), '
                  f'launches {counts}', flush=True)
            check_no_launches(counts, f'vggish ({name})')
            want = np.uint8 if extra else np.float32
            if out.shape != (VGGISH_EXAMPLES, 128) or out.dtype != want \
                    or not np.isfinite(out).all():
                fail(f'vggish ({name}) output {out.shape} {out.dtype} (want '
                     f'({VGGISH_EXAMPLES}, 128) {want.__name__}) or not finite')
            ref = extractor('cpu', **extra).extract(wav)['vggish']
            outs[name] = (out, ref)
            if name == 'plain':
                model = ex.model
            else:
                del ex
        got, ref = outs['plain']
        rel = rel_l2(torch.from_numpy(got), torch.from_numpy(ref))
        print(f'vggish card vs CPU ({VGGISH_EXAMPLES} examples): rel L2 {rel:.3e}',
              flush=True)
        if not rel <= CARD_CPU_REL_L2:
            fail(f'vggish card vs CPU rel L2 {rel} > {CARD_CPU_REL_L2} (TF32 on?)')
        got, ref = (a.astype(np.int16) for a in outs['post_process'])
        diff = np.abs(got - ref)
        print(f'vggish post_process card vs CPU: max {int(diff.max())} level(s) '
              f'apart, {(diff > 0).mean():.4%} of {diff.size} entries differ',
              flush=True)
        if diff.max() > 1:
            fail(f'vggish post_process: card and CPU {int(diff.max())} levels apart')
        for batch in VGGISH_BATCHES:
            x = torch.from_numpy((np.random.RandomState(52 + batch).rand(
                batch, 1, 96, 64) * 7 - 4.6).astype(np.float32)).cuda()
            reps = max(5, 320 // batch)
            with torch.inference_mode():
                ms = cuda_ms(torch, lambda: model(x), reps=reps) / batch
                flops = counted_flops(torch, lambda: model(x)) / batch
                busy = busy_ms(torch, lambda: model(x), BUSY_STEPS)
            bound = flops / FP32_FLOP_PER_S * 1e3
            print(f'vggish VGG step at batch {batch}: {ms:.4f} ms per example over '
                  f'{reps} steps; fp32 FMA bound {bound:.4f} ms ({flops / 1e9:.3f} '
                  f'GFLOP of convolutions and matmuls per example), '
                  f'{bound / ms:.1%} of it', flush=True)
            if busy is None:
                print(f'vggish at batch {batch}: device busy share not measured '
                      '(the profiler recorded no device activity)', flush=True)
            else:
                print(f'vggish at batch {batch}: device busy {busy / batch:.4f} ms '
                      f'per example over {BUSY_STEPS} traced steps, '
                      f'{busy / batch / ms:.1%} of the untraced step time',
                      flush=True)
        from video_features_torch.io.audio import read_wav
        data, sr = read_wav(wav)
        t0 = time.perf_counter()
        for _ in range(5):
            waveform_to_examples(data, sr)
        dsp16 = (time.perf_counter() - t0) / 5
        data48 = read_wav(write_seeded_wav(np, tmp / 'clip48.wav', VGGISH_SECONDS,
                                           VGGISH_RESAMPLED_SR, 53))[0]
        t0 = time.perf_counter()
        n48 = len(waveform_to_examples(data48, VGGISH_RESAMPLED_SR))
        dsp48 = time.perf_counter() - t0
        print(f'vggish host DSP per {VGGISH_SECONDS:g} s clip (the card\'s host, '
              f'{os.cpu_count()} cores): {dsp16 * 1e3:.2f} ms at {sr} Hz '
              f'(mean of 5), {dsp48 * 1e3:.1f} ms at {VGGISH_RESAMPLED_SR} Hz '
              f'(kaiser_best resample; {n48} examples)', flush=True)
        print('vggish: decode_backend=native and audio_backend=native not '
              'exercised on this host (the native library '
              f'{"loads" if native.available() else "does not build"} here); '
              'the wav path needs neither', flush=True)
    del model
    torch.cuda.empty_cache()


def write_clips(np, root: Path, specs, seed: int) -> list:
    """Seeded noise clips written with cv2's MJPG writer; the phase fails
    when cv2 cannot write them."""
    import cv2
    rng = np.random.RandomState(seed)
    paths = []
    for i, (n, h, w) in enumerate(specs):
        path = root / f'clip{seed}_{i}.avi'
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'MJPG'),
                                 PACK_FPS, (w, h))
        if not writer.isOpened():
            fail(f'cv2 cannot write {path.name} (MJPG, {w}×{h})')
        for _ in range(n):
            writer.write(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        writer.release()
        paths.append(str(path))
    return paths


def busy_share(torch, run) -> float:
    """The share of ``run``'s wall time in which the card was busy: the
    union of the kernel and copy intervals ``torch.profiler`` records,
    over the traced run's wall; None when it records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the raw records: prof.events() builds a Python tree over every op
    spans = [(ev.start_ns() / 1e3, (ev.start_ns() + ev.duration_ns()) / 1e3)
             for ev in prof.profiler.kineto_results.events()
             if str(ev.device_type()).endswith('CUDA')]
    return union_ms(spans) / 1e3 / wall if spans else None


def tree_arrays(np, root: str) -> dict:
    return {f.name: np.load(f) for f in sorted(Path(root).rglob('*.npy'))}


def compare_trees(np, a: dict, b: dict, where: str) -> float:
    """The largest rel L2 between two output trees; 0.0 when every file
    is byte-equal. Fails on a missing file, a shape, or more than
    PACK_REL_L2."""
    if a.keys() != b.keys() or not a:
        fail(f'{where}: output files differ: {sorted(a)} vs {sorted(b)}')
    worst = 0.0
    for key in a:
        x, y = a[key], b[key]
        if x.shape != y.shape:
            fail(f'{where}: {key} shapes {x.shape} vs {y.shape}')
        if x.tobytes() != y.tobytes():
            diff = float(np.linalg.norm((x - y).astype(np.float64))
                         / max(np.linalg.norm(y.astype(np.float64)), 1e-30))
            print(f'{where}: {key} differs, rel L2 {diff:.3e}', flush=True)
            worst = max(worst, diff)
    if not worst <= PACK_REL_L2:
        fail(f'{where}: rel L2 {worst} > {PACK_REL_L2}')
    return worst


def packing_phase(torch, np, corr_lookup, gru, check_counts) -> None:
    """The fused I3D path at full width through the per-video loop and
    the packed loop, from clips on disk, through the entry points."""
    from video_features_torch.config import load_config
    from video_features_torch.parallel.packing import VideoTask
    from video_features_torch.registry import create_extractor
    os.environ['VFT_RAFT_LOOKUP'] = 'auto'
    root = ROOT / 'output' / 'packing'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    paths = write_clips(np, root, PACK_CLIPS, seed=40)
    ex = create_extractor(load_config('i3d', overrides={
        'video_paths': paths, 'device': 'cuda', 'streams': None,
        'stack_size': STACK, 'step_size': STACK, 'raft_iters': SLICE_ITERS,
        'batch_size': PACK_BATCH, 'allow_random_weights': True,
        'on_extraction': 'save_numpy', 'output_path': str(root / 'a'),
        'tmp_path': str(root / 'tmp'), 'decode_workers': 2, 'inflight': 2}))
    steps = [0]
    packed_step = ex.packed_step

    def counted_step(x):
        steps[0] += 1
        return packed_step(x)
    ex.packed_step = counted_step

    def packed(tree: str, inflight: int):
        return lambda: ex.extract_packed(
            [VideoTask(p, out_root=str(root / tree)) for p in paths],
            inflight=inflight)

    def per_video(tree: str):
        def run():
            ex.output_path = str(root / tree)
            for p in paths:
                ex._extract(p)
        return run

    runs = (('a: per-video loop, decode_workers 2, inflight 2', 'a', 2,
             per_video('a'), 4),
            ('b: packed loop, decode_workers 1, inflight 1', 'b', 1,
             packed('b', 1), 2),
            ('c: packed loop, decode_workers 1, inflight 2', 'c', 1,
             packed('c', 2), 2))
    ex.decode_workers = 1
    t1 = time.perf_counter()
    packed('warm', 2)()                    # cuDNN's choices, the allocator
    print(f'phase 17: clips written and extractor built in {t1 - t0:.1f} s, '
          f'warm-up run {time.perf_counter() - t1:.1f} s', flush=True)
    windows = sum(PACK_WINDOWS)
    for name, tree, workers, run, want_steps in runs:
        ex.decode_workers = workers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(corr_lookup, gru)
        steps[0] = 0
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(corr_lookup, gru)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f'phase 17 {name}: {wall:.3f} s wall, {windows / wall:.2f} '
              f'windows/s, {steps[0]} fused steps at batch {PACK_BATCH}, '
              f'launches {counts}, peak device memory {peak:.2f} GiB',
              flush=True)
        if steps[0] != want_steps:
            fail(f'phase 17 {name}: {steps[0]} fused steps, want {want_steps}')
        check_counts(counts, 'masked', want_steps, f'phase 17 {name}')
        t1 = time.perf_counter()
        busy = busy_share(torch, per_video(tree + '_traced') if tree == 'a'
                          else packed(tree + '_traced', 1 if tree == 'b' else 2))
        print(f'phase 17 {name}: device busy '
              + ('not measured (the profiler recorded no device activity)'
                 if busy is None else f'{busy:.1%} of a traced run\'s wall')
              + f' (traced run and its read {time.perf_counter() - t1:.1f} s)',
              flush=True)
    trees = {t: tree_arrays(np, str(root / t)) for t in 'abc'}
    width = 1024 * len(ex.streams)          # rgb || flow
    for p, n in zip(paths, PACK_WINDOWS):
        out = trees['c'].get(Path(p).stem + '.npy')
        if out is None or out.shape != (n, width) or not np.isfinite(out).all():
            fail(f'phase 17: {Path(p).name} gave '
                 f'{None if out is None else out.shape}, want ({n}, {width}), finite')
    worst = compare_trees(np, trees['b'], trees['c'], 'phase 17 (b) vs (c)')
    if worst:
        fail(f'phase 17: inflight 1 and 2 differ (rel L2 {worst})')
    worst = compare_trees(np, trees['a'], trees['c'], 'phase 17 (a) vs (c)')
    print(f'phase 17: (b) and (c) byte-equal; (a) against (c) '
          + ('byte-equal' if not worst else f'rel L2 {worst:.3e}'), flush=True)
    del ex
    torch.cuda.empty_cache()
    resnet_packing(torch, np, root, corr_lookup, gru)
    shutil.rmtree(root, ignore_errors=True)


def resnet_packing(torch, np, root: Path, corr_lookup, gru) -> None:
    """resnet50 at batch 32 per video (decode_workers 1 and 4) and
    packed, on four short clips: no kernel launch, the same outputs."""
    from video_features_torch.config import load_config
    from video_features_torch.parallel.packing import VideoTask
    from video_features_torch.registry import create_extractor
    paths = write_clips(np, root, PACK_RESNET_CLIPS, seed=41)
    frames = sum(n for n, _, _ in PACK_RESNET_CLIPS)
    ex = create_extractor(load_config('resnet', overrides={
        'video_paths': paths, 'device': 'cuda', 'model_name': 'resnet50',
        'batch_size': PACK_RESNET_BATCH, 'allow_random_weights': True,
        'on_extraction': 'save_numpy', 'output_path': str(root / 'r'),
        'tmp_path': str(root / 'tmp')}))
    ex.extract_packed([VideoTask(p, out_root=str(root / 'rwarm')) for p in paths])
    for workers in PACK_RESNET_WORKERS:
        ex.decode_workers = workers
        ex.output_path = str(root / f'rv{workers}')
        reset_counts(corr_lookup, gru)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in paths:
            ex._extract(p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(corr_lookup, gru)
        print(f'phase 17 resnet50 per-video loop, decode_workers {workers}: '
              f'{frames / wall:.1f} frames/s ({wall:.3f} s for {frames} frames '
              f'at batch {PACK_RESNET_BATCH}), launches {counts}', flush=True)
        check_no_launches(counts, 'phase 17 resnet50 per-video loop')
    ex.decode_workers = 1
    reset_counts(corr_lookup, gru)
    t0 = time.perf_counter()
    ex.extract_packed([VideoTask(p, out_root=str(root / 'rp')) for p in paths])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(corr_lookup, gru)
    print(f'phase 17 resnet50 packed loop: {frames / wall:.1f} frames/s '
          f'({wall:.3f} s), launches {counts}', flush=True)
    check_no_launches(counts, 'phase 17 resnet50 packed loop')
    packed_tree = tree_arrays(np, str(root / 'rp'))
    for p, (n, _, _) in zip(paths, PACK_RESNET_CLIPS):
        out = packed_tree.get(Path(p).stem + '_resnet.npy')
        if out is None or out.shape != (n, ex.feat_dim) or not np.isfinite(out).all():
            fail(f'phase 17 resnet50: {Path(p).name} gave '
                 f'{None if out is None else out.shape}, want ({n}, {ex.feat_dim})')
    worst = max(compare_trees(np, tree_arrays(np, str(root / f'rv{w}')),
                              packed_tree, f'phase 17 resnet50 (workers {w})')
                for w in PACK_RESNET_WORKERS)
    print('phase 17 resnet50: per-video and packed outputs '
          + ('byte-equal' if not worst else f'within rel L2 {worst:.3e}'),
          flush=True)
    del ex
    torch.cuda.empty_cache()


def rel_arrays(np, root: Path) -> dict:
    """{path under ``root``: array} of every .npy (the families' fps and
    timestamp files share their names)."""
    return {str(f.relative_to(root)): np.load(f)
            for f in sorted(root.rglob('*.npy'))}


def _worker_boot(t_spawn: float, out) -> None:
    """Run in a spawned process: its boot, stage by stage, as a decode
    farm worker pays it (perf_counter is one clock across processes)."""
    marks = [time.perf_counter()]
    import video_features_torch.farm.worker  # noqa: F401
    marks.append(time.perf_counter())
    import cv2  # noqa: F401
    from PIL import Image  # noqa: F401
    marks.append(time.perf_counter())
    from video_features_torch.io import native
    native.load_library()
    marks.append(time.perf_counter())
    out.put([marks[0] - t_spawn] + [b - a for a, b in zip(marks, marks[1:])]
            + [sorted(m for m in ('torch', 'jax') if m in sys.modules)])


def worker_boot() -> None:
    """A spawned process's boot on this host, as a farm worker's; fails
    if it imports torch or jax."""
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    out = ctx.Queue()
    proc = ctx.Process(target=_worker_boot, args=(time.perf_counter(), out))
    proc.start()
    try:
        interp, farm, libs, native, heavy = out.get(timeout=120)
    except queue.Empty:
        proc.kill()
        fail(f'phase 18: a spawned process gave no boot report (exit code '
             f'{proc.exitcode})')
    proc.join(10)
    print(f'phase 18: a spawned worker boots in '
          f'{interp + farm + libs + native:.3f} s: interpreter {interp:.3f}, '
          f'video_features_torch.farm {farm:.3f}, cv2 and PIL {libs:.3f}, the '
          f'native decoder\'s build or load {native:.3f}', flush=True)
    if heavy:
        fail(f'phase 18: a spawned farm worker imported {heavy}')


def farm_ring_mb() -> int:
    """A ring size that lets the most workers of phase 18 fit in the free
    space of ``/dev/shm``; fails, naming what it found, when it cannot."""
    if not os.path.isdir('/dev/shm'):
        fail('phase 18: there is no /dev/shm for the decode farm\'s rings')
    usage = shutil.disk_usage('/dev/shm')
    free_mb = usage.free >> 20
    ring_mb = min(64, free_mb * 3 // 4 // max(FARM_WORKERS))
    print(f'phase 18: /dev/shm {usage.total >> 20} MiB, {free_mb} MiB free; '
          f'os.cpu_count() {os.cpu_count()}; decode_farm_ring_mb {ring_mb} '
          f'for up to {max(FARM_WORKERS)} workers', flush=True)
    if ring_mb < FARM_MIN_RING_MB:
        fail(f'phase 18: /dev/shm has {free_mb} MiB free, too little for '
             f'{max(FARM_WORKERS)} rings of {FARM_MIN_RING_MB} MiB')
    return ring_mb


def check_farm(ex, workers: int, videos: int, windows: int, where: str) -> dict:
    """The run's farm stats; fails unless, at ``workers`` > 1, the farm
    started and shipped every window through its rings, or, at 1, no
    farm ran."""
    if workers == 1:
        if ex._farm is not None:
            fail(f'{where}: a decode farm ran at decode_workers=1')
        return {}
    st = ex._farm.stats() if ex._farm is not None else None
    if st is None or not st['ran']:
        fail(f'{where}: the decode farm did not start '
             f'({None if st is None else st["fallback"]})')
    got = (st['decode_workers'], st['videos_assigned'], st['windows'],
           st['queue_fallback'], st['respawns'], st['videos_failed'])
    if got != (workers, videos, windows, 0, 0, 0):
        fail(f'{where}: the farm shipped (workers, videos, windows, queue '
             f'fallbacks, respawns, failed videos) {got}, want '
             f'{(workers, videos, windows, 0, 0, 0)}')
    return st


def farm_i3d_phase(torch, np, root: Path, ring_mb: int, corr_lookup, gru,
                   check_counts) -> None:
    """(a) The fused I3D path at full width, packed, from
    ``create_extractor(load_config('i3d', ...))`` at the YAML's
    decode_workers, then at 4, against 1, on phase 17's clips and on one
    long clip: the same bytes, every window through the farm, the launch
    counts, wall, the device's busy share and the workers' decode."""
    from video_features_torch.config import load_config
    from video_features_torch.parallel.packing import VideoTask
    from video_features_torch.registry import create_extractor
    from video_features_torch.utils.tracing import Tracer
    os.environ['VFT_RAFT_LOOKUP'] = 'auto'
    corpora = (('short', write_clips(np, root, PACK_CLIPS, seed=40),
                sum(PACK_WINDOWS), FARM_SHORT_STEPS),
               ('long', write_clips(np, root, FARM_LONG_CLIP, seed=42),
                FARM_LONG_WINDOWS, FARM_LONG_STEPS))
    ex = create_extractor(load_config('i3d', overrides={
        'video_paths': corpora[0][1], 'device': 'cuda', 'streams': None,
        'stack_size': STACK, 'step_size': STACK, 'raft_iters': SLICE_ITERS,
        'batch_size': PACK_BATCH, 'allow_random_weights': True,
        'on_extraction': 'save_numpy', 'output_path': str(root / 'i3d'),
        'tmp_path': str(root / 'tmp'), 'pack_across_videos': True,
        'decode_farm_ring_mb': ring_mb}))
    if ex.decode_workers != 2:
        fail(f'phase 18: the i3d YAML gave decode_workers {ex.decode_workers}, '
             'want 2')
    steps = [0]
    packed_step = ex.packed_step

    def counted_step(x):
        steps[0] += 1
        return packed_step(x)
    ex.packed_step = counted_step

    def run(paths, tree):
        ex._farm = None
        ex.extract_packed([VideoTask(p, out_root=str(root / tree)) for p in paths])

    ex.decode_workers = 1
    run(corpora[0][1], 'i3d_warm')                  # cuDNN, the allocator
    for corpus, paths, windows, want_steps in corpora:
        trees = {}
        for workers in FARM_WORKERS:
            where = f'phase 18 (a) {corpus}, decode_workers {workers}'
            ex.decode_workers = workers
            tree = f'i3d_{corpus}_{workers}'
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(corr_lookup, gru)
            steps[0] = 0
            t0 = time.perf_counter()
            run(paths, tree)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts(corr_lookup, gru)
            peak = torch.cuda.max_memory_allocated() / 2**30
            st = check_farm(ex, workers, len(paths), windows, where)
            if steps[0] != want_steps:
                fail(f'{where}: {steps[0]} fused steps, want {want_steps}')
            check_counts(counts, 'masked', want_steps, where)
            print(f'{where}: {wall:.3f} s wall, {windows / wall:.2f} windows/s, '
                  f'{steps[0]} fused steps, launches {counts}, peak device '
                  f'memory {peak:.2f} GiB'
                  + (f', farm start() {st["start_s"]:.3f} s, first window '
                     f'{st["first_window_s"]:.3f} s after it, ring '
                     f'{st["ring_bytes_capacity"] >> 20} MiB in all'
                     if st else ''), flush=True)
            trees[workers] = tree_arrays(np, str(root / tree))
            if corpus != 'short':
                continue
            # a second run, traced by torch.profiler and the stage tracer
            ex.tracer, report = Tracer(), {}
            ex.print_profile = lambda title: report.update(ex.tracer.report())
            t1 = time.perf_counter()
            busy = busy_share(torch, lambda: run(paths, tree + '_traced'))
            traced_wall = time.perf_counter() - t1
            del ex.print_profile
            ex.tracer = Tracer(enabled=False)
            decode = report.get('decode', report.get('decode+preprocess', {}))
            print(f'{where}: device busy '
                  + ('not measured (the profiler recorded no device activity)'
                     if busy is None else f'{busy:.1%} of a traced run\'s wall')
                  + f'; host decode and resize {decode.get("total_s", 0.0):.3f} s '
                  f'over {decode.get("count", 0)} windows '
                  f'({decode.get("total_s", 0.0) / traced_wall:.2f} of the '
                  f'traced wall {traced_wall:.3f} s)'
                  + (f'; shm_copy {report["shm_copy"]["total_s"]:.4f} s, ring '
                     f'fill {report["shm_copy"]["occupancy"]:.1%}'
                     if 'shm_copy' in report else ''), flush=True)
        for workers in FARM_WORKERS[1:]:
            worst = compare_trees(np, trees[1], trees[workers],
                                  f'phase 18 (a) {corpus}, 1 vs {workers}')
            if worst:
                fail(f'phase 18 (a) {corpus}: decode_workers {workers} changed '
                     f'the outputs (rel L2 {worst})')
        width = 1024 * len(ex.streams)
        if any(a.shape[1] != width or not np.isfinite(a).all()
               for a in trees[1].values()):
            fail(f'phase 18 (a) {corpus}: outputs not (T, {width}) and finite')
        print(f'phase 18 (a) {corpus}: decode_workers '
              f'{", ".join(map(str, FARM_WORKERS))} byte-equal', flush=True)
    del ex
    torch.cuda.empty_cache()


def farm_framewise_phase(torch, np, root: Path, ring_mb: int, corr_lookup,
                         gru) -> None:
    """(b) resnet50, and (c) resnet50, CLIP ViT-B/32 and ViT-B/16 fused
    (``features=[resnet,clip,timm]`` through ``load_fused_configs`` and
    ``run_packed_fused``), at batch 32 on eight clips, at decode_workers 1
    and 4: each family's fused files are the bytes of its solo packed
    run, one decode per video against three, and no kernel launch."""
    from video_features_torch.config import load_fused_configs
    from video_features_torch.parallel.packing import run_packed_fused
    from video_features_torch.registry import create_extractor
    paths = write_clips(np, root, FARM_FRAME_CLIPS, seed=43)
    frames = sum(n for n, _, _ in FARM_FRAME_CLIPS)
    overrides = {'video_paths': paths, 'device': 'cuda',
                 'allow_random_weights': True, 'on_extraction': 'save_numpy',
                 'output_path': str(root / 'cfg'), 'tmp_path': str(root / 'tmp'),
                 'batch_size': PACK_RESNET_BATCH, 'pack_across_videos': True,
                 'decode_farm_ring_mb': ring_mb}
    overrides.update({f'{fam}.model_name': m for fam, m in FARM_FAMILIES.items()})
    configs = load_fused_configs(list(FARM_FAMILIES), overrides)
    exs = {fam: create_extractor(args) for fam, args in configs.items()}
    subs = {fam: Path(args['output_path']).relative_to(root / 'cfg')
            for fam, args in configs.items()}
    opened = [0]
    for ex in exs.values():
        packed_windows = ex.packed_windows

        def counting(task, packed_windows=packed_windows):
            opened[0] += 1
            return packed_windows(task)
        ex.packed_windows = counting

    def place(tree, workers):
        for fam, ex in exs.items():
            ex.output_path = str(root / tree / subs[fam])
            ex.decode_workers = workers
            ex._farm = None

    def timed(fn):
        reset_counts(corr_lookup, gru)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, read_counts(corr_lookup, gru)

    place('warm', 1)
    for ex in exs.values():                   # cuDNN, cuBLAS, the allocator
        ex.extract_packed(paths[:1])
    trees = {}
    for workers in FARM_FRAME_WORKERS:
        solo_wall, passes = 0.0, 0
        place(f'solo{workers}', workers)
        for fam, ex in exs.items():
            where = f'phase 18 ({"b" if fam == "resnet" else "c"}) {fam} solo, ' \
                    f'decode_workers {workers}'
            opened[0] = 0
            _, wall, counts = timed(lambda: ex.extract_packed(list(paths)))
            check_no_launches(counts, where)
            st = check_farm(ex, workers, len(paths), frames, where)
            passes += st['videos_assigned'] if st else opened[0]
            solo_wall += wall
            print(f'{where}: {frames / wall:.1f} frames/s ({wall:.3f} s for '
                  f'{frames} frames at batch {ex.batch_size})'
                  + (f', farm start() {st["start_s"]:.3f} s, first window '
                     f'{st["first_window_s"]:.3f} s after it' if st else ''),
                  flush=True)
        place(f'fused{workers}', workers)
        opened[0] = 0
        stats, wall, counts = timed(lambda: run_packed_fused(exs, list(paths)))
        where = f'phase 18 (c) fused, decode_workers {workers}'
        check_no_launches(counts, where)
        st = check_farm(exs['resnet'], workers, len(paths),
                        frames * len(exs), where)
        fused_passes = st['videos_assigned'] if st else stats['decode_passes']
        if opened[0] or stats != {'videos': len(paths),
                                  'decode_passes': len(paths)} \
                or fused_passes != len(paths) or passes != len(exs) * len(paths):
            fail(f'{where}: decode passes {fused_passes} fused ({stats}) and '
                 f'{passes} solo, want {len(paths)} and '
                 f'{len(exs) * len(paths)}')
        print(f'{where}: {wall:.3f} s wall ({frames * len(exs) / wall:.1f} '
              f'frames/s over the three families) against {solo_wall:.3f} s '
              f'for the three solo runs; {fused_passes} decode passes against '
              f'{passes}', flush=True)
        trees[workers] = {k: rel_arrays(np, root / f'{k}{workers}')
                          for k in ('solo', 'fused')}
    for workers in FARM_FRAME_WORKERS:
        for kind in ('solo', 'fused'):
            worst = compare_trees(np, trees[1]['solo'], trees[workers][kind],
                                  f'phase 18 (b, c) {kind} at {workers}')
            if worst:
                fail(f'phase 18 (b, c): {kind} at decode_workers {workers} '
                     f'differs from solo at 1 (rel L2 {worst})')
    for fam, ex in exs.items():
        for p, (n, _, _) in zip(paths, FARM_FRAME_CLIPS):
            out = trees[1]['solo'].get(f'{subs[fam]}/{Path(p).stem}_{fam}.npy')
            if out is None or out.shape != (n, ex.feat_dim) \
                    or not np.isfinite(out).all():
                fail(f'phase 18 (c) {fam}: {Path(p).name} gave '
                     f'{None if out is None else out.shape}, want '
                     f'({n}, {ex.feat_dim}), finite')
    print('phase 18 (b, c): solo and fused outputs at decode_workers '
          f'{" and ".join(map(str, FARM_FRAME_WORKERS))} byte-equal', flush=True)
    del exs
    torch.cuda.empty_cache()


def farm_phase(torch, np, corr_lookup, gru, check_counts) -> None:
    """Phase 18: the decode farm and fused worklists; no ring is left in
    /dev/shm and no worker process is left running."""
    import multiprocessing
    root = ROOT / 'output' / 'farm'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ring_mb = farm_ring_mb()
    shm_before = set(os.listdir('/dev/shm'))
    worker_boot()
    farm_i3d_phase(torch, np, root, ring_mb, corr_lookup, gru, check_counts)
    farm_framewise_phase(torch, np, root, ring_mb, corr_lookup, gru)
    gc.collect()
    left = sorted(set(os.listdir('/dev/shm')) - shm_before)
    children = multiprocessing.active_children()
    if left or children:
        fail(f'phase 18: left behind: /dev/shm {left}, processes {children}')
    print('phase 18: no ring left in /dev/shm, no worker process running',
          flush=True)
    shutil.rmtree(root, ignore_errors=True)


# -- phase 19: the precision lanes -------------------------------------------


def params_nbytes(tree) -> int:
    """Resident bytes of a params tree (an int8 weight counts its int8
    payload and its fp32 scales)."""
    return sum(params_nbytes(v) if isinstance(v, dict) else
               (v.nbytes if not hasattr(v, 'element_size')
                else v.numel() * v.element_size())
               for v in tree.values())


def ptxas_report(log: str, key: str) -> list:
    """ptxas's register, barrier and spill lines (and any wgmma warning)
    for the entry functions whose name holds ``key``, from an ``nvcc
    -Xptxas -v`` log."""
    keep, lines = False, []
    for line in log.splitlines():
        if 'entry function' in line:
            keep = key in line
        if keep and any(k in line for k in ('entry function', 'registers',
                                            'spill', 'wgmma')):
            lines.append(line.strip())
    return lines


def gru_one_pass_phase(torch, gru, pr14, build_log: str, lib_path: Path):
    """(a): the one-pass kernel (``gru_tf32_onepass``, clusters of CTAs
    sharing multicast weight tiles) against its plain version (the fp32
    convolution of the TF32-rounded operands), float64 and the 3xTF32
    kernel (must differ), both axes, at the two main-path shapes; its
    cluster size, ring depth, tile, registers, spills and HGMMA count;
    its time against ``pr14_one_pass`` (the one-pass instantiation of
    the 3xTF32 schedule, built from this source by
    ``tools/gru_tf32x3_variants.py``) in turns, old, new, new, old, both
    called into preallocated outputs; the plain version's time, the two
    cuDNN convs under TF32 (``library_ms``) and its bound: a third of the
    3xTF32 products at the TF32 rate."""
    from tools import gru_tf32x3_variants as variants
    from video_features_torch.utils.device import precision_scope
    lib = gru._library()
    for line in ptxas_report(build_log, 'gru_tf32_onepass'):
        print(f'  ptxas gru_tf32_onepass: {line}', flush=True)
    hgmma = {k: n for k, n in sass_counts(lib_path, 'HGMMA').items()
             if 'gru_tf32_onepass' in k}
    print(f'gru_tf32_onepass SASS: HGMMA instructions per instantiation '
          f'{hgmma}', flush=True)
    if not hgmma or not all(hgmma.values()):
        fail(f'the one-pass GRU kernel has no tensor-core (HGMMA) '
             f'instructions: {hgmma}')
    gen = torch.Generator(device='cuda').manual_seed(11)

    def randn(*s):
        return torch.randn(*s, device='cuda', generator=gen)
    rec = {'err': 0.0, 'at': {}}
    for shape in GRU_SHAPES[:2]:
        x = (torch.tanh(randn(*shape, 128)), randn(*shape, 128),
             *gru.pack_direction(0.05 * randn(256, 256, 1, 5),
                                 0.05 * randn(128, 256, 1, 5)),
             0.1 * randn(*shape, 256), 0.1 * randn(*shape, 128))
        outs = tuple(torch.empty_like(x[0]) for _ in range(3))
        m = shape[0] * shape[1] * shape[2]
        for axis in gru.AXES:
            cfg = variants.one_pass_config(lib, shape[2], axis)
            got = gru.gru_direction(*x, axis, passes=1)
            torch.cuda.synchronize()
            plain = gru.gru_direction_plain(*x, axis, passes=1)
            diff = (got - plain).abs()
            err, mean = diff.max().item(), diff.mean().item()
            flips = (diff > KERNEL_ATOL).float().mean().item()
            ref = gru.gru_direction_plain(*[t.double() for t in x], axis,
                                          passes=1)
            old = variants.direction_call(pr14, x, axis, 1, outs)
            torch.cuda.synchronize()
            print(f'gru 1xTF32 {shape} axis {axis} (cluster {cfg["cluster"]}, '
                  f'ring {cfg["stages"]} x 16 KB, BM {cfg["bm"]}, '
                  f'{cfg["smem"]} B shared per CTA): against float64 (the '
                  f'rounded operands): kernel '
                  f'{(got - ref).abs().max().item():.3e}, plain '
                  f'{(plain - ref).abs().max().item():.3e}, pr14_one_pass '
                  f'{(old - ref).abs().max().item():.3e}; kernel vs plain '
                  f'mean abs {mean:.3e}, {flips:.2e} of outputs past '
                  f'{KERNEL_ATOL:g}', flush=True)
            del ref
            three = (got - gru.gru_direction(*x, axis)).abs().max().item()
            rec['err'] = max(rec['err'], err)
            if err > GRU1_ATOL or mean > GRU1_MEAN_ATOL:
                fail(f'one-pass GRU kernel disagrees with its plain version '
                     f'at {shape} axis {axis}: max {err}, mean {mean}')
            if not three > 0:
                fail(f'one-pass GRU kernel equals the 3xTF32 one at {shape}')
            turns = []
            for which in ('old', 'new', 'new', 'old'):
                turns.append(cuda_ms(torch, lambda: variants.direction_call(
                    pr14 if which == 'old' else lib, x, axis, 1, outs), 20))
            ms, old_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            convs = [gru._conv_weight(gru.unpack_direction(w), axis)
                     for w in x[2:4]]
            plain_ms = cuda_ms(torch, lambda: gru.gru_direction_plain(
                *x, axis, passes=1), 5)
            with precision_scope('tensorfloat32'):
                lib_ms = cuda_ms(torch, lambda: gru.gru_direction_convs(
                    x[0], x[1], *convs, x[4], x[5], axis), 5)
            bound = gru_bound_ms(m)['tf32x3'] / 3
            feed = variants.feed_bytes(shape, axis, cfg['cluster'], cfg['bm'])
            feed_old = variants.feed_bytes(shape, axis, 1,
                                           variants.pr14_bm(shape[2], axis))
            rec['at'][(shape, axis)] = (ms, plain_ms, lib_ms, bound, old_ms)
            print(f'gru 1xTF32 {shape} axis {axis} (M={m}): max abs err '
                  f'{err:.3e} vs its plain version ({three:.3e} from 3xTF32); '
                  f'in turns old/new/new/old {turns[0]:.4f} / {turns[1]:.4f} / '
                  f'{turns[2]:.4f} / {turns[3]:.4f} ms: {ms:.4f} ms against '
                  f'pr14_one_pass {old_ms:.4f} ({old_ms / ms:.2f}x); L2 -> SM '
                  f'{feed["total"] / 1e9:.3f} GB ({feed["total"] / ms / 1e9:.2f} '
                  f'TB/s) against {feed_old["total"] / 1e9:.3f} GB '
                  f'({feed_old["total"] / old_ms / 1e9:.2f} TB/s); plain '
                  f'{plain_ms:.4f} ms, cuDNN convs (TF32) {lib_ms:.4f} ms; '
                  f'bound {bound:.4f} ms (operations, 1xTF32 at '
                  f'{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s), {bound / ms:.1%} of '
                  f'it (pr14_one_pass {bound / old_ms:.1%})', flush=True)
            if ms > old_ms * ONE_PASS_SLOWER:
                fail(f'the one-pass GRU kernel is slower than pr14_one_pass at '
                     f'{shape} axis {axis}: {ms:.4f} against {old_ms:.4f} ms')
        del x, outs
    torch.cuda.empty_cache()
    at = [rec['at'][(GRU_SHAPES[0], a)] for a in gru.AXES]
    rec['ms'] = sum(a[0] for a in at) / len(at)
    rec['plain_ms'] = sum(a[1] for a in at) / len(at)
    rec['library_ms'] = sum(a[2] for a in at) / len(at)
    rec['bound_ms'], rec['bound_by'] = at[0][3], 'operations'
    rec['pr14_one_pass_ms'] = sum(a[4] for a in at) / len(at)
    return rec


def step_breakdown(torch, ex, batch) -> None:
    """One traced step (``torch.profiler``, in the extractor's lane): the
    device time by kernel group (``tools/profile_torch_i3d.py``'s groups),
    the top kernels and the device's busy share of the step's wall."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile
    from tools.profile_torch_i3d import group_of
    x = torch.from_numpy(batch).cuda()
    with torch.inference_mode(), ex.precision_scope():
        ex.packed_step(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex.packed_step(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    by_name, spans = defaultdict(float), []
    for ev in prof.events():
        if str(getattr(ev, 'device_type', '')).endswith('CUDA'):
            by_name[ev.name] += (ev.time_range.end - ev.time_range.start) / 1e3
            spans.append((ev.time_range.start, ev.time_range.end))
    if not spans:
        print(f'{ex.feature_type} precision={ex.precision}: breakdown not '
              'measured (the profiler recorded no device activity)', flush=True)
        return
    total = sum(by_name.values())
    groups = defaultdict(float)
    for name, ms in by_name.items():
        groups[group_of(name)] += ms
    print(f'{ex.feature_type} precision={ex.precision} traced step: kernels '
          f'{total:.1f} ms, device busy {union_ms(spans):.1f} ms of {wall:.1f} '
          f'ms wall ({union_ms(spans) / wall:.1%}); by group: ' + ', '.join(
              f'{g} {ms:.1f} ms ({ms / total:.1%})' for g, ms in
              sorted(groups.items(), key=lambda kv: -kv[1])), flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f'  {ms:9.2f} ms  {name[:90]}', flush=True)


def lane_extractor(feature_type: str, precision: str, compute_dtype: str,
                   **overrides):
    """An extractor from ``load_config`` and ``create_extractor`` on a
    lane, with the seeded random weights every lane shares."""
    from video_features_torch.config import load_config
    from video_features_torch.registry import create_extractor
    return create_extractor(load_config(feature_type, {
        'video_paths': str(ROOT / 'chip_smoke.py'), 'device': 'cuda',
        'allow_random_weights': True, 'on_extraction': 'save_numpy',
        'output_path': str(ROOT / 'output'), 'precision': precision,
        'compute_dtype': compute_dtype, **overrides}))


def timed_step(torch, ex, batch, reps: int):
    """The step's outputs on ``batch`` (``run_step``: put, dispatch in the
    lane's scope, fetch), its device ms per call and the peak device
    memory of a call."""
    out = ex.run_step(batch)
    x = torch.from_numpy(batch).cuda()
    with torch.inference_mode(), ex.precision_scope():
        ms = cuda_ms(torch, lambda: ex.packed_step(x), reps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ex.packed_step(x)
        torch.cuda.synchronize()
    return out, ms, torch.cuda.max_memory_allocated()


def raft_lane_counts(corr_lookup, gru, passes: int, pairs_steps: int,
                     iters: int, where: str) -> int:
    """The launches of a RAFT-bearing run on a lane: a lookup and two GRU
    directions (of the lane's pass count) per iteration and step."""
    counts = read_counts(corr_lookup, gru)
    key = 'gru' if passes == 3 else 'gru1'
    want = {'masked': pairs_steps * iters, key: 2 * pairs_steps * iters,
            'gru1' if passes == 3 else 'gru': 0, 'padded': 0}
    if counts != want:
        fail(f'{where}: launches {counts}, want {want}')
    return counts


def lanes_flow_phase(torch, np, corr_lookup, gru, launches, drift) -> None:
    """(b): the fused I3D step at batch 8 and the RAFT family at batch 8
    pairs under highest, high (mixed's arithmetic: TF32 libraries, the GRU
    kernel in 3xTF32) and tensorfloat32 (the one-pass kernel), each driven
    through ``extract_frames`` with the counts reset just before and read
    just after, rel L2 against highest per stream and per flow field, and
    ms per window or pair; under tensorfloat32 the RAFT step with the
    kernels against their plain versions."""
    from video_features_torch.models import raft as raft_model
    frames = rand_frames(np, 60, (LANE_I3D_FRAMES, *FRAME_HW, 3))
    rframes = raft_frames(np)[:LANE_RAFT_BATCH + 1]
    feats, rflows = {}, {}
    for prec in LANE_PRECISIONS:
        passes = 1 if prec == 'tensorfloat32' else 3
        ex = lane_extractor('i3d', prec, 'float32', stack_size=STACK,
                            step_size=STACK, raft_iters=SLICE_ITERS,
                            batch_size=LANE_BATCH, concat_rgb_flow=False)
        ex.extract_frames(frame_batches(frames[:STACK + 1]))      # warm-up
        torch.cuda.synchronize()
        reset_counts(corr_lookup, gru)
        feats[prec] = ex.extract_frames(frame_batches(frames))
        torch.cuda.synchronize()
        counts = raft_lane_counts(corr_lookup, gru, passes, 1, SLICE_ITERS,
                                  f'I3D at batch {LANE_BATCH}, precision={prec}')
        for key in launches:
            launches[key] += counts[key]
        stacks = np.stack([frames[i * STACK:i * STACK + STACK + 1]
                           for i in range(LANE_BATCH)])
        _, ms, peak = timed_step(torch, ex, stacks, 2)
        print(f'i3d precision={prec}: {ms / LANE_BATCH:.2f} ms per window at '
              f'batch {LANE_BATCH} ({SLICE_ITERS} RAFT iterations), peak '
              f'{peak / 2**30:.2f} GiB, launches {counts}', flush=True)
        if prec == LANE_PRECISIONS[-1]:
            step_breakdown(torch, ex, stacks)
        del ex
        rex = lane_extractor('raft', prec, 'float32', batch_size=LANE_RAFT_BATCH,
                             raft_iters=SLICE_ITERS)
        rex.run_step(rframes)                                       # warm-up
        torch.cuda.synchronize()
        reset_counts(corr_lookup, gru)
        out = rex.extract_frames([(list(rframes), list(range(len(rframes))),
                                   None)], RAFT_FPS)
        torch.cuda.synchronize()
        counts = raft_lane_counts(corr_lookup, gru, passes, 1, SLICE_ITERS,
                                  f'RAFT family at batch {LANE_RAFT_BATCH}, '
                                  f'precision={prec}')
        for key in launches:
            launches[key] += counts[key]
        rflows[prec] = out['raft']
        _, ms, _ = timed_step(torch, rex, rframes, 2)
        print(f'raft precision={prec}: {ms / LANE_RAFT_BATCH:.2f} ms per pair '
              f'at batch {LANE_RAFT_BATCH} ({SLICE_ITERS} iterations)', flush=True)
        if prec == 'tensorfloat32':
            x = torch.from_numpy(rframes).cuda()
            padded, _ = raft_model.pad_to_multiple(x)
            with torch.inference_mode(), rex.precision_scope():
                outs = [raft_model.forward_consecutive(
                    rex.params, padded, iters=CHECK_ITERS, plain_kernels=plain,
                    gru_passes=1) for plain in (False, True)]
            rel = rel_l2(*outs)
            print(f'raft precision=tensorfloat32: flow, kernels (one-pass GRU) '
                  f'vs plain versions rel L2 {rel:.3e} ({CHECK_ITERS} '
                  f'iterations)', flush=True)
            if not rel <= SLICE_REL_L2:
                fail(f'one-pass lane: kernels vs plain rel L2 {rel}')
        del rex
    for prec in LANE_PRECISIONS[1:]:
        for s in ('rgb', 'flow'):
            got, ref = feats[prec][s], feats['highest'][s]
            rel = rel_l2(torch.from_numpy(got), torch.from_numpy(ref))
            print(f'i3d {s} stream, precision={prec} vs highest: rel L2 '
                  f'{rel:.3e} ({len(ref)} windows)', flush=True)
            if not np.isfinite(got).all():
                fail(f'i3d {s} stream under precision={prec} not finite')
            if prec == 'high':
                drift['i3d'] = max(drift.get('i3d', 0.0), rel)
        fields = [rel_l2(torch.from_numpy(a), torch.from_numpy(b))
                  for a, b in zip(rflows[prec], rflows['highest'])]
        print(f'raft flow, precision={prec} vs highest: rel L2 per flow field '
              f'max {max(fields):.3e}, median {sorted(fields)[len(fields) // 2]:.3e} '
              f'({len(fields)} fields)', flush=True)
        if prec == 'high':
            drift['raft'] = max(fields)
    torch.cuda.empty_cache()


def lanes_dtype_phase(torch, np, corr_lookup, gru, drift) -> None:
    """(c) and (d): each bf16 family at its config batch (the frame-wise
    ones at batch 32 too) under highest (the fp32 lane, the reference),
    high (mixed's arithmetic), compute_dtype=bfloat16 and, for resnet50,
    CLIP ViT-B/32 and ViT-B/16, compute_dtype=int8: rel L2 against the
    fp32 lane (held to the JAX package's bounds), ms per frame, window or
    example, peak device memory and resident param bytes; no kernel
    launches."""
    from video_features_torch.ops import precision as lanes
    from video_features_torch.registry import BF16_FEATURES, INT8_FEATURES
    for ft, model, overrides, batches, make in LANE_FAMILIES:
        if ft not in BF16_FEATURES:
            fail(f'{ft} is not in registry.BF16_FEATURES')
        runs = [('highest', 'float32'), ('high', 'float32'),
                ('highest', 'bfloat16')]
        if ft in INT8_FEATURES:
            runs.append(('highest', 'int8'))
        data = {batch: make(np, batch) for batch in batches}
        ref = {}
        for prec, dtype in runs:
            ex = lane_extractor(ft, prec, dtype, batch_size=batches[0],
                                **overrides)
            for batch in batches:
                reset_counts(corr_lookup, gru)
                if ft == 'vggish':
                    out = ex._run_batched(data[batch])
                    x = torch.from_numpy(data[batch]).to(ex.act_dtype).cuda()
                    with torch.inference_mode(), ex.precision_scope():
                        ms = cuda_ms(torch, lambda: ex.model(x), 5)
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        ex.model(x)
                        torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated()
                    nbytes = sum(p.numel() * p.element_size()
                                 for p in ex.model.parameters())
                else:
                    out, ms, peak = timed_step(torch, ex, data[batch], 5)
                    out = out[ft]
                    nbytes = params_nbytes(ex.params)
                check_no_launches(read_counts(corr_lookup, gru),
                                  f'{model} lane ({prec}, {dtype})')
                if out.dtype != np.float32 or not np.isfinite(out).all():
                    fail(f'{model} ({prec}, {dtype}): output {out.dtype}, '
                         f'finite {np.isfinite(out).all()}')
                line = (f'{model} batch {batch} precision={prec} '
                        f'compute_dtype={dtype}: {ms / batch:.4f} ms per item, '
                        f'peak {peak / 2**20:.1f} MiB, params '
                        f'{nbytes / 2**20:.1f} MiB')
                if batch not in ref:
                    ref[batch] = out
                else:
                    rel = lanes.rel_l2(ref[batch], out)
                    line += f', rel L2 vs the fp32 lane {rel:.3e}'
                    if dtype != 'float32':
                        bound = (lanes.BF16_REL_L2_BOUNDS if dtype == 'bfloat16'
                                 else lanes.INT8_REL_L2_BOUNDS)[ft]
                        line += f' (bound {bound:g})'
                        if not 0 < rel <= bound:
                            fail(f'{model} {dtype} lane rel L2 {rel} not in '
                                 f'(0, {bound}]')
                    else:
                        drift[ft] = max(drift.get(ft, 0.0), rel)
                print(line, flush=True)
            del ex
        torch.cuda.empty_cache()


def lanes_resize_phase(torch, np, transforms) -> None:
    """(e): ``pil_resize_bilinear_device`` under tensorfloat32 byte-equal
    to the host's PIL resize and to the CPU, the I3D geometry included."""
    from video_features_torch.ops.host_transforms import resize_pil
    from video_features_torch.utils.device import precision_scope
    for i, (h, w, oh, ow) in enumerate(RESIZE_GEOMETRIES[:2]
                                       + RESIZE_GEOMETRIES[-1:]):
        x = rand_frames(np, 70 + i, (2, h, w, 3))
        host = np.stack([resize_pil(f, min(oh, ow)) for f in x])
        with precision_scope('tensorfloat32'):
            card = transforms.pil_resize_bilinear_device(
                torch.from_numpy(x).cuda(), (oh, ow)).cpu().numpy()
        same = host.shape == card.shape and np.array_equal(host, card)
        print(f'device resize under tensorfloat32, {h}x{w} -> {oh}x{ow}: '
              f'{"byte-equal to" if same else "DIFFERS from"} the host PIL resize',
              flush=True)
        if not same:
            fail(f'device resize under TF32 differs from PIL at {h}x{w}')


def lanes_phase(torch, np, corr_lookup, gru, transforms, launches, pr14,
                build_log: str, lib_path: Path) -> dict:
    """Phase 19: (a) the one-pass GRU kernel, (b) the flow families, (c)
    and (d) the bf16 and int8 lanes, (e) the resize under TF32; then
    ``registry.MIXED_FEATURES`` against the measured drifts of mixed."""
    from video_features_torch.config import load_config
    from video_features_torch.registry import EXTRACTORS, MIXED_FEATURES
    rec = gru_one_pass_phase(torch, gru, pr14, build_log, lib_path)
    drift = {}
    lanes_flow_phase(torch, np, corr_lookup, gru, launches, drift)
    lanes_dtype_phase(torch, np, corr_lookup, gru, drift)
    lanes_resize_phase(torch, np, transforms)
    print('precision=mixed drift (rel L2 against highest, max over streams '
          'and flow fields): ' + json.dumps(
              {k: float(f'{v:.3e}') for k, v in sorted(drift.items())}),
          flush=True)
    for ft in EXTRACTORS:
        if ft not in drift:
            fail(f'no mixed drift measured for {ft}')
        if (drift[ft] <= MIXED_BAR) != (ft in MIXED_FEATURES):
            fail(f'registry.MIXED_FEATURES and the card disagree on {ft}: '
                 f'drift {drift[ft]:.3e} against the {MIXED_BAR:g} bar')
        overrides = {'video_paths': str(ROOT / 'chip_smoke.py'),
                     'device': 'cuda', 'precision': 'mixed'}
        if ft == 'timm':
            overrides['model_name'] = TIMM_VIT
        if ft in MIXED_FEATURES:
            load_config(ft, overrides)
        else:
            try:
                load_config(ft, overrides)
            except NotImplementedError as e:
                if 'precision' not in str(e):
                    fail(f'{ft}: the mixed refusal does not name precision')
            else:
                fail(f'{ft} accepts precision=mixed outside MIXED_FEATURES')
    return rec


# -- phase 20: the feature cache ----------------------------------------------


def cache_extract(ex, paths, steps) -> list:
    """``_extract`` over ``paths``: (outcome, wall s) per video, the step
    counter reset first."""
    steps[0] = 0
    runs = []
    for p in paths:
        t0 = time.perf_counter()
        outcome = ex._extract(p)
        runs.append((outcome, time.perf_counter() - t0))
    return runs


def cache_gc(cache_dir: Path) -> tuple:
    """``python -m video_features_torch.cache.gc --verify`` on a directory:
    (exit code, report)."""
    proc = subprocess.run(
        [sys.executable, '-m', 'video_features_torch.cache.gc', '--cache-dir',
         str(cache_dir), '--verify'], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode not in (0, 1) or not lines:
        fail(f'phase 20 (e): the GC exited {proc.returncode}: {proc.stderr}')
    return proc.returncode, json.loads(lines[-1])


def cache_phase(torch, np, corr_lookup, gru, check_counts, card: str) -> None:
    """Phase 20: the feature cache on the I3D path at batch 8 over phase
    17's clips and a byte copy of one of them: (a) per video, a missing
    run then a hit run; (b) packed through the decode farm, the copy
    parked; (c) a fused frame-wise worklist hashing each file once; (d) a
    second L1 over (a)'s L2; (e) the GC entry point and a truncated
    entry."""
    import multiprocessing

    from video_features_torch.config import load_config, load_fused_configs
    from video_features_torch.parallel.packing import VideoTask, run_packed_fused
    from video_features_torch.registry import create_extractor
    from video_features_torch.utils.fingerprint import (
        hash_file, hash_file_stats, reset_hash_file_stats,
    )
    from video_features_torch.utils.tracing import Tracer
    os.environ['VFT_RAFT_LOOKUP'] = 'auto'
    root = ROOT / 'output' / 'cache'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shm_before = set(os.listdir('/dev/shm'))
    paths = write_clips(np, root, PACK_CLIPS, seed=40)
    copy = root / 'clip40_0_copy.avi'
    shutil.copyfile(paths[0], copy)
    corpus = paths + [str(copy)]
    l1a, l2 = root / 'l1a', root / 'l2'

    def i3d_args(out: str, l1: Path, **kw):
        return load_config('i3d', overrides={
            'video_paths': corpus, 'device': 'cuda', 'streams': None,
            'stack_size': STACK, 'step_size': STACK, 'raft_iters': SLICE_ITERS,
            'batch_size': PACK_BATCH, 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'output_path': str(root / out),
            'tmp_path': str(root / 'tmp'), 'cache_enabled': True,
            'cache_dir': str(l1), **kw})

    t0 = time.perf_counter()
    ex = create_extractor(i3d_args('a1', l1a, cache_l2_dir=str(l2)))
    ex.tracer = Tracer()
    ex.print_profile = lambda title: None
    steps = [0]
    packed_step = ex.packed_step

    def counted_step(x):
        steps[0] += 1
        return packed_step(x)
    ex.packed_step = counted_step
    cache, ex.cache = ex.cache, None        # a warm-up that leaves no entry
    ex.output_path = str(root / 'warm')
    cache_extract(ex, [paths[1], paths[3]], steps)   # both geometries
    ex.cache, ex.output_path = cache, str(root / 'a1')
    print(f'phase 20: clips written, extractor built and warmed up in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # (a) the per-video loop: a missing run, then a run that is all hits
    torch.cuda.synchronize()
    ex.tracer.reset()
    reset_counts(corr_lookup, gru)
    run1 = cache_extract(ex, corpus, steps)
    torch.cuda.synchronize()
    counts = read_counts(corr_lookup, gru)
    outcomes = [o for o, _ in run1]
    if outcomes != ['saved'] * len(paths) + ['cached']:
        fail(f'phase 20 (a) run 1: outcomes {outcomes}, want four saved and '
             'the byte copy cached')
    if steps[0] != len(paths):
        fail(f'phase 20 (a) run 1: {steps[0]} fused steps, want {len(paths)}')
    check_counts(counts, 'masked', steps[0], 'phase 20 (a) run 1')
    rep1 = ex.tracer.report()
    st = ex.cache.stats()
    if (st['puts'], st['l2_publishes'], st['hits']) != (len(paths), len(paths), 1):
        fail(f'phase 20 (a) run 1: cache stats {st}')
    ex.tracer.reset()
    ex.output_path = str(root / 'a2')
    reset_counts(corr_lookup, gru)
    run2 = cache_extract(ex, corpus, steps)
    torch.cuda.synchronize()
    counts2 = read_counts(corr_lookup, gru)
    rep2 = ex.tracer.report()
    if [o for o, _ in run2] != ['cached'] * len(corpus) or steps[0] \
            or any(counts2.values()):
        fail(f'phase 20 (a) run 2: outcomes {[o for o, _ in run2]}, '
             f'{steps[0]} fused steps, launches {counts2}: want all hits, '
             'no step, no launch')
    tree_a1 = tree_arrays(np, str(root / 'a1'))
    worst = compare_trees(np, tree_arrays(np, str(root / 'a2')), tree_a1,
                          'phase 20 (a) hit run vs missing run')
    copy_out, orig_out = tree_a1.get(copy.stem + '.npy'), tree_a1.get(
        Path(paths[0]).stem + '.npy')
    if worst or copy_out is None or orig_out is None \
            or copy_out.tobytes() != orig_out.tobytes():
        fail('phase 20 (a): the hit run or the byte copy is not byte-identical')
    width = 1024 * len(ex.streams)
    for p, n in zip(paths, PACK_WINDOWS):
        out = tree_a1[Path(p).stem + '.npy']
        if out.shape != (n, width) or not np.isfinite(out).all():
            fail(f'phase 20 (a): {Path(p).name} gave {out.shape}, want '
                 f'({n}, {width}), finite')
    miss_ms = [w * 1e3 for o, w in run1 if o == 'saved']
    hit_ms = [w * 1e3 for _, w in run2]
    publish_ms = rep1['cache_publish']['mean_s'] * 1e3
    lookup_ms = rep2['cache_lookup']['mean_s'] * 1e3
    print(f'phase 20 (a) per video ({card}): missed-and-published '
          f'{", ".join(f"{m:.1f}" for m in miss_ms)} ms (mean '
          f'{sum(miss_ms) / len(miss_ms):.1f}), launches {counts}, '
          f'{len(paths)} fused steps; the byte copy a hit in run 1 '
          f'({run1[-1][1] * 1e3:.2f} ms); hit run {", ".join(f"{h:.2f}" for h in hit_ms)} '
          f'ms (mean {sum(hit_ms) / len(hit_ms):.2f}), 0 steps, 0 launches; '
          f'publish overhead {publish_ms:.2f} ms per video (L1 and L2), lookup '
          f'{lookup_ms:.2f} ms per hit; outputs byte-identical', flush=True)

    # (b) packed through the decode farm on a cold cache: the copy parks
    ex.configure_cache(i3d_args('b', root / 'l1b'))
    ex.decode_workers = 2
    torch.cuda.synchronize()
    reset_counts(corr_lookup, gru)
    steps[0] = 0
    t1 = time.perf_counter()
    tasks = [VideoTask(p, out_root=str(root / 'b')) for p in corpus]
    ex.extract_packed(tasks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts(corr_lookup, gru)
    fs = ex._farm.stats()
    if not fs['ran'] or fs['deduped'] < 1 \
            or fs['videos_assigned'] != len(corpus) - 1 \
            or not tasks[-1].cached or steps[0] < 2:
        fail(f'phase 20 (b): farm stats {fs}, copy cached {tasks[-1].cached}, '
             f'{steps[0]} fused steps: want the copy parked and one decode '
             'fewer than the tasks')
    check_counts(counts, 'masked', steps[0], 'phase 20 (b)')
    worst = compare_trees(np, tree_arrays(np, str(root / 'b')), tree_a1,
                          'phase 20 (b) vs (a)')
    if worst:
        fail(f'phase 20 (b): outputs differ from (a) (rel L2 {worst})')
    print(f'phase 20 (b) packed, decode_workers 2, cold cache ({card}): '
          f'{wall:.3f} s wall, {fs["videos_assigned"]} decodes for '
          f'{len(corpus)} tasks, deduped {fs["deduped"]}, {steps[0]} fused '
          f'steps, launches {counts}; outputs byte-equal to (a)', flush=True)

    # (c) a fused frame-wise worklist over fresh copies: one hash per file
    csrc = root / 'c_src'
    csrc.mkdir()
    fused_paths = [str(shutil.copyfile(p, csrc / Path(p).name)) for p in corpus]
    configs = load_fused_configs(list(FARM_FAMILIES), {
        'video_paths': fused_paths, 'device': 'cuda',
        'allow_random_weights': True, 'on_extraction': 'save_numpy',
        'output_path': str(root / 'c'), 'tmp_path': str(root / 'tmp'),
        'batch_size': PACK_RESNET_BATCH, 'cache_enabled': True,
        'cache_dir': str(root / 'l1c'),
        **{f'{fam}.model_name': m for fam, m in FARM_FAMILIES.items()}})
    exs = {fam: create_extractor(args) for fam, args in configs.items()}
    reset_hash_file_stats()
    reset_counts(corr_lookup, gru)
    t1 = time.perf_counter()
    res = run_packed_fused(exs, list(fused_paths))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    passes = hash_file_stats()['passes']
    counts = read_counts(corr_lookup, gru)
    if passes != len(fused_paths) or any(counts.values()):
        fail(f'phase 20 (c): {passes} hash passes for {len(fused_paths)} '
             f'files (want one each), launches {counts}')
    for fam, fex in exs.items():
        for p in fused_paths:
            f = Path(fex.output_path) / f'{Path(p).stem}_{fam}.npy'
            if not f.exists() or not np.isfinite(np.load(f)).all():
                fail(f'phase 20 (c): {fam} output of {Path(p).name} missing '
                     'or not finite')
    print(f'phase 20 (c) features=[{",".join(FARM_FAMILIES)}] fused, cold '
          f'cache ({card}): {passes} hash passes for {len(fused_paths)} files '
          f'and {len(exs)} families, {res["decode_passes"]} decode passes, '
          f'{exs["resnet"].cache.stats()["puts"]} publishes, {wall:.3f} s '
          'wall, 0 launches', flush=True)
    hash_dir = root / 'hash'
    hash_dir.mkdir()
    fresh = [shutil.copyfile(p, hash_dir / Path(p).name) for p in corpus]
    nbytes = sum(os.path.getsize(p) for p in fresh)
    t1 = time.perf_counter()
    for p in fresh:
        hash_file(str(p))
    dt = time.perf_counter() - t1
    print(f'phase 20: hash_file at {nbytes / dt / 1e6:.1f} MB/s over '
          f'{len(fresh)} files, {nbytes / 1e6:.2f} MB, page cache warm '
          f'({card})', flush=True)
    del exs
    torch.cuda.empty_cache()

    # (d) a second L1 over the L2 that (a) filled: every video from the L2
    ex.configure_cache(i3d_args('d', root / 'l1d', cache_l2_dir=str(l2)))
    ex.output_path = str(root / 'd')
    reset_counts(corr_lookup, gru)
    run_d = cache_extract(ex, paths, steps)
    counts = read_counts(corr_lookup, gru)
    st = ex.cache.stats()
    if [o for o, _ in run_d] != ['cached'] * len(paths) or steps[0] \
            or any(counts.values()) or st['peer_hits'] != len(paths):
        fail(f'phase 20 (d): outcomes {[o for o, _ in run_d]}, {steps[0]} '
             f'steps, launches {counts}, peer hits {st["peer_hits"]}: want '
             f'{len(paths)} L2 hits and no step')
    tree_d = tree_arrays(np, str(root / 'd'))
    if compare_trees(np, tree_d, {k: tree_a1[k] for k in tree_d},
                     'phase 20 (d) vs (a)') or len(tree_d) != len(paths):
        fail('phase 20 (d): L2-served outputs differ from (a)')
    peer_ms = [w * 1e3 for _, w in run_d]
    print(f'phase 20 (d) a fresh L1 over the L2 ({card}): {st["peer_hits"]} '
          f'peer hits, promoted into L1 ({st["entries"]} entries), '
          f'{", ".join(f"{m:.2f}" for m in peer_ms)} ms per video, 0 steps, '
          '0 launches; outputs byte-equal to (a)', flush=True)

    # (e) the GC: clean, then one truncated stored file
    rc, report = cache_gc(l1a)
    if rc != 0 or report['corrupt_evicted'] or report['entries_after'] != len(paths):
        fail(f'phase 20 (e): GC on the clean store exited {rc}: {report}')
    victim_key = ex._video_cache_key(paths[1])
    victim = l1a / 'objects' / victim_key[:2] / victim_key / 'rgb.npy'
    victim.write_bytes(victim.read_bytes()[:-16])
    rc1, report1 = cache_gc(l1a)
    if rc1 != 1 or report1['corrupt_evicted'] != 1:
        fail(f'phase 20 (e): GC after a truncation exited {rc1}: {report1}')
    # L1 alone (the L2 would serve the video): the store as GC left it
    ex.configure_cache(i3d_args('e', l1a))
    ex.output_path = str(root / 'e')
    reset_counts(corr_lookup, gru)
    run_e = cache_extract(ex, paths, steps)
    torch.cuda.synchronize()
    counts = read_counts(corr_lookup, gru)
    want = ['cached'] * len(paths)
    want[1] = 'saved'
    if [o for o, _ in run_e] != want or steps[0] != 1:
        fail(f'phase 20 (e): outcomes {[o for o, _ in run_e]}, {steps[0]} '
             f'steps: want {paths[1]} re-extracted in one step')
    check_counts(counts, 'masked', 1, 'phase 20 (e)')
    name = Path(paths[1]).stem + '.npy'
    if tree_arrays(np, str(root / 'e'))[name].tobytes() != tree_a1[name].tobytes():
        fail('phase 20 (e): the re-extracted video differs from (a)')
    print(f'phase 20 (e) GC --verify ({card}): exit 0 on the clean store '
          f'({report["entries_after"]} entries); after truncating one stored '
          f'file exit 1, {report1["corrupt_evicted"]} corrupt evicted; the '
          f'next run re-extracted that video in 1 step (launches {counts}), '
          'byte-equal to (a), and served the rest', flush=True)
    gc.collect()
    left = sorted(set(os.listdir('/dev/shm')) - shm_before)
    children = multiprocessing.active_children()
    if left or children:
        fail(f'phase 20: left behind: /dev/shm {left}, processes {children}')
    del ex
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)


# the flight recorder: the JAX package's trace-event key set (its
# tests/test_obs.py contract), the I3D path of phase 17 per video with
# every obs knob and without, the recorder's cost over FLIGHT_REPEATS
# alternating runs of each, and SPAN_APPENDS appends timed alone
TRACE_EVENT_KEYS = frozenset({'name', 'ph', 'ts', 'dur', 'pid', 'tid', 'args',
                              's'})
FLIGHT_REPEATS, SPAN_APPENDS = 3, 100_000
FARM_WINDOW_SLACK_S = 0.05      # the farm's clock exchange: trusted below it


def kernel_events(trace_dir: Path) -> dict:
    """The CUDA kernel events of the one ``torch.profiler`` trace under
    ``trace_dir``, counted by kernel name."""
    traces = list(trace_dir.glob('*.pt.trace.json'))
    if len(traces) != 1:
        fail(f'phase 21 (b): {len(traces)} torch.profiler traces under '
             f'{trace_dir}, want 1')
    with open(traces[0]) as f:
        doc = json.load(f)
    counts = {}
    for ev in doc.get('traceEvents', []):
        if ev.get('cat') == 'kernel':
            counts[ev['name']] = counts.get(ev['name'], 0) + 1
    return counts


def check_trace(trace_path: str, where: str, extra=()) -> list:
    """The trace of a run: valid (``obs.spans.validate_events``: keys,
    monotonic timestamps, durations), every key in the JAX package's set,
    every stage span's name in ``STAGES`` or ``extra``; returns its
    events."""
    from video_features_torch.obs.spans import validate_events
    from video_features_torch.utils.tracing import STAGES
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    errors = validate_events(events)
    if errors:
        fail(f'{where}: the trace is not valid: {errors[:5]}')
    stray = sorted({k for e in events for k in e} - TRACE_EVENT_KEYS)
    if stray:
        fail(f'{where}: trace event keys outside the JAX set: {stray}')
    names = {e['name'] for e in events if e['ph'] == 'X'} - {'video'}
    if not names <= set(STAGES) | set(extra):
        fail(f'{where}: stage spans outside STAGES: {sorted(names - set(STAGES))}')
    return events


def flight_phase(torch, np, corr_lookup, gru, check_counts, card: str) -> None:
    """Phase 21: the flight recorder on the I3D path of phase 17 at the
    i3d YAML (batch 8, stack 16, RAFT 20 iterations): (a) per video with
    trace_out, manifest_out, postmortem_dir and profile_dir against the
    same run without them, in a cold build directory; (b) the
    torch.profiler trace's kernels against the launch counters; (c)
    packed through the decode farm at 2 workers; (d) what the recorder
    costs."""
    import multiprocessing

    from video_features_torch.config import load_config
    from video_features_torch.obs.spans import SpanRecorder
    from video_features_torch.ops import _kernels
    from video_features_torch.registry import create_extractor
    from video_features_torch.utils.tracing import Tracer, torch_profiler_trace
    os.environ['VFT_RAFT_LOOKUP'] = 'auto'
    root = ROOT / 'output' / 'flight'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shm_before = set(os.listdir('/dev/shm'))
    paths = write_clips(np, root, PACK_CLIPS, seed=40)
    windows = sum(PACK_WINDOWS)

    def i3d(tag: str, **kw):
        return create_extractor(load_config('i3d', overrides={
            'video_paths': paths, 'device': 'cuda', 'streams': None,
            'stack_size': STACK, 'step_size': STACK, 'raft_iters': SLICE_ITERS,
            'batch_size': PACK_BATCH, 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'output_path': str(root / tag),
            'tmp_path': str(root / 'tmp'), **kw}))

    def per_video(ex, tag: str) -> float:
        ex.output_path = str(root / tag)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outcomes = [ex._extract(p) for p in paths]
        torch.cuda.synchronize()
        if outcomes != ['saved'] * len(paths):
            fail(f'phase 21 {tag}: outcomes {outcomes}')
        return time.perf_counter() - t0

    obs = {'trace_out': str(root / 'a_trace.json'),
           'manifest_out': str(root / 'a_manifest.json'),
           'postmortem_dir': str(root / 'postmortem')}
    t0 = time.perf_counter()
    ex_off = i3d('off')
    per_video(ex_off, 'warm')               # cuDNN's choices, the allocator
    wall_off = per_video(ex_off, 'off')
    print(f'phase 21: clips written, extractor built, warm-up and the run '
          f'without the knobs ({wall_off:.3f} s) in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # (a) + (b): every knob, in a cold build directory, the run profiled
    _kernels.BUILD_DIR = root / 'build'
    for fn in (_kernels.load, corr_lookup._library, gru._library):
        fn.cache_clear()
    ex_on = i3d('on', **obs)
    prof_dir = root / 'profile'
    reset_counts(corr_lookup, gru)
    with torch_profiler_trace(str(prof_dir)):
        wall_on = per_video(ex_on, 'on')
    counts = read_counts(corr_lookup, gru)
    ex_on.finish_obs()
    check_counts(counts, 'masked', len(paths), 'phase 21 (a)')
    worst = compare_trees(np, tree_arrays(np, str(root / 'on')),
                          tree_arrays(np, str(root / 'off')),
                          'phase 21 (a) knobs on vs off')
    if worst:
        fail('phase 21 (a): telemetry changed the output bytes')
    events = check_trace(obs['trace_out'], 'phase 21 (a)')
    videos = [e for e in events if e['ph'] == 'X' and e['name'] == 'video']
    got = sorted((e['args']['video'], e['args']['outcome']) for e in videos)
    tids = {e['args'].get('trace_id') for e in videos}
    if got != sorted((p, 'saved') for p in paths) or len(tids) != 1 \
            or None in tids:
        fail(f'phase 21 (a): video spans {got}, trace ids {tids}: want one '
             'saved span per clip under one trace id')
    with open(obs['manifest_out']) as f:
        man = json.load(f)
    if man['outcomes'] != {'saved': len(paths)} \
            or not {'model', 'd2h'} <= set(man['stages']):
        fail(f'phase 21 (a): manifest outcomes {man["outcomes"]}, stages '
             f'{sorted(man["stages"])}')
    compiled = man['compile']
    if set(compiled) != {f'nvcc:{k}' for k in KERNELS} \
            or any(r['count'] != 1 or r['total_s'] <= 0
                   for r in compiled.values()):
        fail(f'phase 21 (a): a cold build directory gave compile {compiled}, '
             f'want one build of each of {KERNELS}')
    stage_ms = {k: round(v['mean_s'] * 1e3, 3) for k, v in man['stages'].items()}
    print(f'phase 21 (a) ({card}): outputs byte-identical with and without '
          f'trace_out, manifest_out, postmortem_dir and profile_dir; trace of '
          f'{len(events)} events valid, keys in the JAX set, '
          f'{len(videos)} video spans saved under one trace id; manifest '
          f'outcomes {man["outcomes"]}, stage means (ms) {stage_ms}; cold '
          'build directory: compile '
          + ', '.join(f'{k} {r["count"]} build in {r["total_s"]:.1f} s'
                      for k, r in sorted(compiled.items()))
          + f'; wall {wall_on:.3f} s profiled with the cold builds, '
          f'{wall_off:.3f} s without the knobs', flush=True)
    kernels = kernel_events(prof_dir)
    masked = sum(n for k, n in kernels.items() if 'masked_kernel' in k)
    gru3 = sum(n for k, n in kernels.items() if 'gru_tf32x3' in k)
    gru1 = sum(n for k, n in kernels.items() if 'gru_tf32_onepass' in k)
    # ops/gru.py counts one per direction, each the zr and the q kernel
    if masked != counts['masked'] or gru3 != 2 * counts['gru'] \
            or gru1 != 2 * counts['gru1']:
        fail(f'phase 21 (b): the trace shows {masked} masked_kernel, '
             f'{gru3} gru_tf32x3 and {gru1} gru_tf32_onepass launches; the '
             f'counters say {counts}')
    print(f'phase 21 (b) ({card}): the torch.profiler trace under profile_dir '
          f'shows {masked} masked_kernel launches (lookup counter '
          f'{counts["masked"]}), {gru3} gru_tf32x3 launches (GRU counter '
          f'{counts["gru"]} directions of 2 kernels) and {gru1} '
          f'gru_tf32_onepass launches (one-pass counter {counts["gru1"]}); '
          f'{len(kernels)} kernel names in all', flush=True)

    # (c) packed through the decode farm at the YAML's 2 workers
    ex_pack = i3d('c', pack_across_videos=True,
                  trace_out=str(root / 'c_trace.json'),
                  manifest_out=str(root / 'c_manifest.json'))
    reset_counts(corr_lookup, gru)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    ex_pack.extract_packed(paths)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = read_counts(corr_lookup, gru)
    ex_pack.finish_obs()
    check_counts(counts, 'masked', FARM_SHORT_STEPS, 'phase 21 (c)')
    check_farm(ex_pack, 2, len(paths), windows, 'phase 21 (c)')
    compare_trees(np, tree_arrays(np, str(root / 'c')),
                  tree_arrays(np, str(root / 'on')), 'phase 21 (c) vs (a)')
    # the farm's parent-side ring copy is a stage of the port's own
    events = check_trace(str(root / 'c_trace.json'), 'phase 21 (c)',
                         extra=('shm_copy',))
    origin = ex_pack.tracer.recorder.origin()
    decode = [e for e in events if e['name'] == 'decode']
    lanes = {e['pid'] for e in decode} - {os.getpid()}
    early = min(origin + e['ts'] / 1e6 for e in decode) - t_start
    late = t_end - max(origin + (e['ts'] + e['dur']) / 1e6 for e in decode)
    if len(decode) != windows or len(lanes) < 2 \
            or min(early, late) < -FARM_WINDOW_SLACK_S:
        fail(f'phase 21 (c): {len(decode)} decode spans on worker lanes '
             f'{sorted(lanes)}, {early:.4f} s after the run began and '
             f'{late:.4f} s before it ended: want {windows} on 2 lanes inside')
    with open(root / 'c_manifest.json') as f:
        man = json.load(f)
    if man['farm'].get('decode_workers') != 2 \
            or man['outcomes'] != {'saved': len(paths)}:
        fail(f'phase 21 (c): manifest farm {man["farm"]}, outcomes '
             f'{man["outcomes"]}')
    print(f'phase 21 (c) ({card}): packed through the farm, {len(decode)} '
          f'decode spans on {len(lanes)} worker pid lanes, inside the run '
          f'({early * 1e3:.1f} ms after its start, {late * 1e3:.1f} ms before '
          f'its end); manifest farm decode_workers {man["farm"]["decode_workers"]}, '
          f'executables {sorted(man["executables"])}; outputs byte-equal to '
          f'(a); wall {t_end - t_start:.3f} s', flush=True)
    del ex_pack
    gc.collect()
    left = sorted(set(os.listdir('/dev/shm')) - shm_before)
    children = multiprocessing.active_children()
    if left or children:
        fail(f'phase 21 (c): left behind: /dev/shm {left}, processes {children}')

    # (d) the recorder's cost: trace_out and manifest_out on and off, in
    # turns, on a warm build directory
    ex_on.configure_obs(dict(obs, trace_out=str(root / 'd_trace.json'),
                             manifest_out=str(root / 'd_manifest.json')))
    walls = {'off': [], 'on': []}
    for i, mode in enumerate(['off', 'on', 'on', 'off', 'off', 'on']
                             [:2 * FLIGHT_REPEATS]):
        ex = ex_on if mode == 'on' else ex_off
        walls[mode].append(per_video(ex, f'd{i}_{mode}'))
    ex_on.finish_obs()
    with open(root / 'd_manifest.json') as f:
        warm = json.load(f)['compile']
    if warm != {}:
        fail(f'phase 21 (d): a warm build directory gave compile {warm}')
    rec = SpanRecorder(capacity=SPAN_APPENDS)
    t = time.perf_counter()
    for _ in range(SPAN_APPENDS):
        rec.span('model', t, t + 1e-3, videos=paths[:1], valid=8)
    span_us = (time.perf_counter() - t) / SPAN_APPENDS * 1e6
    traced = Tracer(recorder=SpanRecorder(capacity=SPAN_APPENDS))
    plain = Tracer()
    stage_us = {}
    for name, tr in (('with the recorder', traced), ('without', plain)):
        t = time.perf_counter()
        for _ in range(SPAN_APPENDS):
            with tr.stage('model', valid=8):
                pass
        stage_us[name] = (time.perf_counter() - t) / SPAN_APPENDS * 1e6
    for mode in ('off', 'on'):
        ms = [w / windows * 1e3 for w in walls[mode]]
        print(f'phase 21 (d) ({card}): trace_out and manifest_out {mode}: '
              f'corpus wall {", ".join(f"{w:.3f}" for w in walls[mode])} s, '
              f'{", ".join(f"{m:.2f}" for m in ms)} ms per window '
              f'({windows} windows, {len(paths)} videos)', flush=True)
    print(f'phase 21 (d) ({card}): SpanRecorder.span {span_us:.3f} us per '
          f'append; Tracer.stage {stage_us["with the recorder"]:.3f} us with '
          f'the recorder, {stage_us["without"]:.3f} us without; a warm build '
          'directory gave compile {}', flush=True)
    del ex_on, ex_off
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)


SP_REL_L2 = 1e-5    # ring vs blockwise online softmax: block reassociation
MULTIHOST_TIMEOUT_S = 300


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def tree_bytes(root: Path) -> dict:
    return {str(f.relative_to(root)): f.read_bytes()
            for f in sorted(Path(root).rglob('*.npy'))}


def same_bytes(a: dict, b: dict, where: str) -> None:
    if not a or a != b:
        diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
        fail(f'{where}: outputs differ from one device: {diff or "none written"}')


def multihost_runs(np, root: Path, paths, one: dict) -> None:
    """(a): two CLI processes over gloo on the one card."""
    port = free_port()
    procs, t0 = [], time.perf_counter()
    for rank in (0, 1):
        cmd = [sys.executable, '-m', 'video_features_torch', 'feature_type=i3d',
               'device=cuda', 'multihost=true',
               f'coordinator_address=127.0.0.1:{port}', 'num_processes=2',
               f'process_id={rank}', f'video_paths=[{",".join(paths)}]',
               f'stack_size={STACK}', f'step_size={STACK}',
               f'raft_iters={SLICE_ITERS}', f'batch_size={PACK_BATCH}',
               'allow_random_weights=true', 'on_extraction=save_numpy',
               f'output_path={root / "multihost"}', f'tmp_path={root / "tmp"}']
        procs.append(subprocess.Popen(cmd, cwd=str(ROOT), text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    shards = []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=MULTIHOST_TIMEOUT_S)
            wall = time.perf_counter() - t0
            print(f'phase 22 (a) multihost process {rank}: exit {proc.returncode}'
                  f', {wall:.2f} s wall from both starts', flush=True)
            if proc.returncode != 0:
                fail(f'phase 22 (a): process {rank} exited {proc.returncode}:\n'
                     f'{out[-1500:]}\n{err[-1500:]}')
            shards.append([p for p in paths if f'] {p}' in out])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if shards != [paths[0::2], paths[1::2]]:
        fail(f'phase 22 (a): shards {shards}, want disjoint and interleaved '
             f'{[paths[0::2], paths[1::2]]}')
    same_bytes(tree_bytes(root / 'multihost' / 'i3d'), one,
               'phase 22 (a) multihost')
    print(f'phase 22 (a): shards {[len(s) for s in shards]} videos, disjoint and '
          'interleaved; every output byte-equal to the one-process run',
          flush=True)


def sequence_parallel_runs(torch, np) -> None:
    """(d): ViT-B/16 at 768 px on a one-card ring through the extractor,
    and a two-shard ring on the one card, against the blockwise path."""
    from video_features_torch.config import load_config
    from video_features_torch.models import vit as vit_model
    from video_features_torch.ops.transforms import normalize, to_float_zero_one
    from video_features_torch.parallel.mesh import make_mesh
    from video_features_torch.registry import create_extractor
    frames = rand_frames(np, 41, (TIMM_LONG_FRAMES, TIMM_LONG_SIZE, TIMM_LONG_SIZE, 3))
    times = [i / FRAMEWISE_FPS * 1000 for i in range(TIMM_LONG_FRAMES)]
    batches = [([f], [t], None) for f, t in zip(frames, times)]
    rows = {}
    for sp in (False, True):
        ex = create_extractor(load_config('timm', overrides={
            'video_paths': [str(ROOT / 'output' / 'frames.mp4')],
            'device': 'cuda', 'model_name': TIMM_VIT,
            'image_size': TIMM_LONG_SIZE, 'sequence_parallel': sp,
            'allow_random_weights': True, 'batch_size': 1,
            'output_path': str(ROOT / 'output'), 'tmp_path': str(ROOT / 'tmp')}))
        rows[sp] = ex.extract_frames(batches, FRAMEWISE_FPS)['timm']
    rel = rel_l2(torch.from_numpy(rows[True]), torch.from_numpy(rows[False]))
    print(f'phase 22 (d) sequence_parallel through the extractor, a ring over '
          f'{ex._mesh.shape["time"]} card(s), {TIMM_VIT} at {TIMM_LONG_SIZE} px: '
          f'rel L2 {rel:.3e}, max abs '
          f'{np.abs(rows[True] - rows[False]).max():.3e} against blockwise',
          flush=True)
    if not rel <= SP_REL_L2:
        fail(f'phase 22 (d): one-card ring vs blockwise rel L2 {rel} > {SP_REL_L2}')
    cuda0 = torch.device('cuda', 0)
    x = normalize(to_float_zero_one(torch.from_numpy(frames[:1]).to(cuda0)),
                  ex.data_cfg['mean'], ex.data_cfg['std'])
    rings = {n: make_mesh(devices=[cuda0] * n, time_parallel=n) for n in (1, 2)}
    runs = {'blockwise': lambda: vit_model.forward(ex.params, x, arch=ex.arch)}
    for n, mesh in rings.items():
        runs[f'ring of {n}'] = functools.partial(
            vit_model.forward_sequence_parallel, ex.params, x, mesh, arch=ex.arch)
    with torch.inference_mode():
        ref = runs['blockwise']()
        for name, run in runs.items():
            out = run()
            ms = cuda_ms(torch, run, reps=5)
            rel = rel_l2(out, ref)
            print(f'phase 22 (d) {TIMM_VIT} forward at {TIMM_LONG_SIZE} px, batch 1, '
                  f'{name} on cuda:0: {ms:.3f} ms, rel L2 {rel:.3e}, max abs '
                  f'{(out - ref).abs().max().item():.3e} against blockwise',
                  flush=True)
            if not rel <= SP_REL_L2:
                fail(f'phase 22 (d): {name} vs blockwise rel L2 {rel} > {SP_REL_L2}')
    del ex, x
    torch.cuda.empty_cache()


def parallel_phase(torch, np, corr_lookup, gru, check_counts) -> None:
    """Several processes and devices on the I3D path of phase 17 and on
    resnet50 and ViT-B/16: ``multihost`` over gloo, the mesh knobs, two
    shards on one card, ``sequence_parallel``, and two cards where the
    machine has them."""
    from video_features_torch.config import load_config
    from video_features_torch.parallel.mesh import make_mesh
    from video_features_torch.parallel.packing import VideoTask
    from video_features_torch.registry import create_extractor
    t_phase = time.perf_counter()
    os.environ['VFT_RAFT_LOOKUP'] = 'auto'
    root = ROOT / 'output' / 'parallel'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    paths = write_clips(np, root, PACK_CLIPS, seed=40)
    n_cards = torch.cuda.device_count()

    def i3d(tree: str, **over):
        return create_extractor(load_config('i3d', overrides={
            'video_paths': paths, 'device': 'cuda', 'streams': None,
            'stack_size': STACK, 'step_size': STACK, 'raft_iters': SLICE_ITERS,
            'batch_size': PACK_BATCH, 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'output_path': str(root / tree),
            'tmp_path': str(root / 'tmp'), 'decode_workers': 1, **over}))

    def counted(where, run, steps, kernels=True):
        torch.cuda.synchronize()
        reset_counts(corr_lookup, gru)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(corr_lookup, gru)
        print(f'phase 22 {where}: {wall:.3f} s wall, launches {counts}', flush=True)
        if kernels:
            check_counts(counts, 'masked', steps, f'phase 22 {where}')
        else:
            check_no_launches(counts, f'phase 22 {where}')

    def per_video(ex):
        return lambda: [ex._extract(p) for p in paths]

    # the one-device references: per video (4 steps) and packed (2 steps)
    ex = i3d('one')
    per_video(ex)()                         # warm-up: cuDNN's choices
    shutil.rmtree(root / 'one')
    counted('one device, per video', per_video(ex), 4)
    one = tree_bytes(Path(ex.output_path))
    counted('one device, packed', lambda: ex.extract_packed(
        [VideoTask(p, out_root=str(root / 'one_packed')) for p in paths]), 2)
    one_packed = tree_bytes(root / 'one_packed')
    same_bytes(one_packed, one, 'phase 22 packed vs per video')
    del ex
    torch.cuda.empty_cache()

    t = time.perf_counter()
    multihost_runs(np, root, paths, one)
    print(f'phase 22 (a) {time.perf_counter() - t:.1f} s', flush=True)

    # (b) the mesh knobs on this machine's cards
    ex = i3d('mesh0', mesh_devices=0, pack_across_videos=True)
    if ex.mesh_devices != n_cards:
        fail(f'phase 22 (b): mesh_devices=0 resolved to {ex.mesh_devices}, '
             f'want {n_cards}')
    # each geometry's pool (5 and 6 windows) flushes once: 2 batches, each
    # split into one shard per card
    counted(f'(b) mesh_devices=0 ({ex.mesh_devices} card(s)), packed',
            lambda: ex.extract_packed(paths), 2 * n_cards)
    same_bytes(tree_bytes(Path(ex.output_path)), one, 'phase 22 (b) mesh_devices=0')
    del ex
    try:
        i3d('overask', mesh_devices=n_cards + 1)
        fail(f'phase 22 (b): mesh_devices={n_cards + 1} did not raise')
    except ValueError as e:
        if f'only {n_cards} local cuda device(s)' not in str(e):
            fail(f'phase 22 (b): the over-ask raised {e!r}')
        print(f'phase 22 (b) mesh_devices={n_cards + 1}: ValueError: {e}', flush=True)
    ex = i3d('dp', data_parallel=True)
    if ex._mesh.shape != {'data': n_cards, 'time': 1}:
        fail(f'phase 22 (b): data_parallel mesh {ex._mesh.shape}')
    counted(f'(b) data_parallel over {n_cards} card(s), per video',
            per_video(ex), 4 * n_cards)
    same_bytes(tree_bytes(Path(ex.output_path)), one, 'phase 22 (b) data_parallel')
    del ex
    torch.cuda.empty_cache()

    # (c) two shards on the one card: 8 windows per shard, 16 per batch;
    # each geometry's pool flushes once, so 2 batches × 2 shard steps
    cuda0 = torch.device('cuda', 0)
    ex = i3d('two_shards')
    ex.use_mesh(make_mesh(devices=[cuda0, cuda0], time_parallel=1))
    counted('(c) two shards on cuda:0, packed I3D', lambda: ex.extract_packed(
        paths), 4)
    same_bytes(tree_bytes(Path(ex.output_path)), one_packed,
               'phase 22 (c) two shards')
    del ex
    torch.cuda.empty_cache()
    rpaths = write_clips(np, root, PACK_RESNET_CLIPS, seed=41)

    def resnet(tree: str):
        return create_extractor(load_config('resnet', overrides={
            'video_paths': rpaths, 'device': 'cuda', 'model_name': 'resnet50',
            'batch_size': PACK_RESNET_BATCH, 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'output_path': str(root / tree),
            'tmp_path': str(root / 'tmp'), 'decode_workers': 1}))
    ex = resnet('resnet_one')
    ex.extract_packed(rpaths)               # warm-up, then the reference
    shutil.rmtree(ex.output_path)
    counted('(c) resnet50 packed, one device', lambda: ex.extract_packed(rpaths),
            0, kernels=False)
    ref = tree_bytes(Path(ex.output_path))
    ex = resnet('resnet_two')
    ex.use_mesh(make_mesh(devices=[cuda0, cuda0], time_parallel=1))
    counted('(c) resnet50 packed, two shards on cuda:0',
            lambda: ex.extract_packed(rpaths), 0, kernels=False)
    same_bytes(tree_bytes(Path(ex.output_path)), ref,
               'phase 22 (c) resnet50 two shards')
    print('phase 22 (c): I3D and resnet50 over two shards on cuda:0 byte-equal '
          'to one device', flush=True)
    del ex
    torch.cuda.empty_cache()

    t = time.perf_counter()
    sequence_parallel_runs(torch, np)
    print(f'phase 22 (d) {time.perf_counter() - t:.1f} s', flush=True)

    # (e) the repair's witness: the kernels' shared-memory attributes are
    # set per device, so a second card launches them too
    if n_cards >= 2:
        ex = i3d('two_cards', mesh_devices=2)
        counted('(e) a data mesh over two cards, packed', lambda: ex.extract_packed(
            paths), 4)
        same_bytes(tree_bytes(Path(ex.output_path)), one_packed,
                   'phase 22 (e) two cards')
        print('phase 22 (e): two cards byte-equal to one', flush=True)
    else:
        print(f'phase 22 (e): NOT RUN: this machine has {n_cards} card; the '
              'two-card data_parallel check (the per-device shared-memory '
              'attributes on a second card) counts as not run, not as passed',
              flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(f'phase 22 wall {time.perf_counter() - t_phase:.1f} s', flush=True)


# -- phase 23: the serve daemon -------------------------------------------------

# three of phase 17's clips (3, 2 and 5 windows)
SERVE_CLIPS = PACK_CLIPS[:3]
SERVE_WINDOWS = PACK_WINDOWS[:3]
SERVE_OBS = {'watchdog_stall_s': 30, 'slo_latency_p99_s': 60,
             'slo_availability': 0.99}
# the sustained stream's corpus: phase 17's four clip shapes six times
# over (24 clips, 66 windows), each clip a request of its own
STREAM_CLIPS = PACK_CLIPS * 6
STREAM_WINDOWS = PACK_WINDOWS * 6


def serve_base(root: Path) -> dict:
    """The fused I3D configuration at full width (both towers at 224,
    stack 16, step 16, RAFT 20 iterations, batch 8, seeded random weights,
    the card), as base overrides of a serve daemon."""
    return {'device': 'cuda', 'stack_size': STACK, 'step_size': STACK,
            'raft_iters': SLICE_ITERS, 'batch_size': PACK_BATCH,
            'allow_random_weights': True, 'on_extraction': 'save_numpy',
            'tmp_path': str(root / 'tmp')}


def serve_request(client, paths, out: str, timeout_s: float = 600) -> tuple:
    """Submit ``paths`` into ``out`` and wait: (status, wall seconds)."""
    t0 = time.perf_counter()
    st = client.wait(client.submit('i3d', paths, overrides={'output_path': out}),
                     timeout_s=timeout_s)
    return st, time.perf_counter() - t0


def serve_stream(client, paths, out: str) -> tuple:
    """Every clip of ``paths`` as a request of its own, all submitted at
    once into ``out``: (seconds from the first submit to the last answer,
    the requests' latencies as the server measured them, their states)."""
    t0 = time.perf_counter()
    rids = [client.submit('i3d', [p], overrides={'output_path': out})
            for p in paths]
    sts = [client.wait(rid, timeout_s=600) for rid in rids]
    return (time.perf_counter() - t0, [st.get('latency_s') for st in sts],
            [st['state'] for st in sts])


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile of ``values`` by nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def child_pids(pid: int) -> list:
    """The processes whose parent is ``pid`` (from /proc)."""
    out = []
    for entry in os.listdir('/proc'):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f'/proc/{entry}/stat').read_text()
        except OSError:
            continue
        if int(stat.rsplit(')', 1)[1].split()[1]) == pid:
            out.append(int(entry))
    return out


def serve_subprocess_phase(root: Path, paths: list, card: str,
                           prewarm: bool) -> tuple:
    """(d) ``python -m video_features_torch serve`` on the card (with
    ``serve_prewarm=i3d`` when ``prewarm``), one request from
    ``ServeClient``, then SIGTERM: exit 0, the drained line, a merged
    ``trace_out`` whose spans cover the request, no ring left in
    /dev/shm and no child process alive. Returns (seconds to the
    endpoint line, the first request's wall)."""
    import signal
    from video_features_torch.serve.client import ServeClient
    tag = 'prewarm' if prewarm else 'cold'
    where = f'phase 23 (d, {tag})'
    trace = root / f'serve_trace_{tag}.json'
    args = [f'{k}={v}' for k, v in serve_base(root / f'sub_{tag}').items()]
    args.append(f'trace_out={trace}')
    if prewarm:
        args.append('serve_prewarm=i3d')
    shm_before = set(os.listdir('/dev/shm'))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, '-m', 'video_features_torch', 'serve', *args],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        endpoint_s = time.perf_counter() - t0
        if not line.startswith('serving on '):
            proc.kill()
            fail(f'{where}: no endpoint line: {line!r} '
                 f'{proc.stderr.read()[-2000:]}')
        port = int(line.split()[2].rsplit(':', 1)[1])
        client = ServeClient(port=port)
        st, first_wall = serve_request(client, paths[:1], str(root / f'd_{tag}'))
        trace_id = st.get('trace_id')
        if st['state'] != 'done':
            proc.kill()
            fail(f'{where}: the request ended {st}')
        m = client.metrics()
        children = child_pids(proc.pid)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    builds = (m['warm_pool']['builds_compiled'], m['warm_pool']['misses'])
    if builds != ((1, 0) if prewarm else (1, 1)):
        fail(f'{where}: warm pool {m["warm_pool"]}: want one build, '
             + ('at start-up' if prewarm else 'by the request'))
    print(f'{where} [{card}]: endpoint line {endpoint_s:.3f} s after the '
          f'start{" (the pre-warm included)" if prewarm else ""}, first '
          f'request {first_wall:.3f} s wall; drained '
          f'{time.perf_counter() - t_term:.3f} s after SIGTERM, exit '
          f'{proc.returncode}', flush=True)
    if proc.returncode != 0 or 'serve: drained, exiting' not in stdout:
        fail(f'{where}: exit {proc.returncode}, stdout {stdout[-500:]!r}, '
             f'stderr {stderr[-2000:]}')
    deadline = time.monotonic() + 10
    alive = children
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if Path(f'/proc/{p}').exists()
                 and 'Z' not in Path(f'/proc/{p}/stat').read_text().split()[2]]
        time.sleep(0.1)
    left = sorted(set(os.listdir('/dev/shm')) - shm_before)
    if left or alive:
        fail(f'{where}: left behind: /dev/shm {left}, processes {alive}')
    try:
        events = json.loads(trace.read_text())['traceEvents']
    except (OSError, ValueError, KeyError) as e:
        fail(f'{where}: no merged trace at {trace}: {e}')
    mine = [e for e in events
            if (e.get('args') or {}).get('trace_id') == trace_id
            or trace_id in ((e.get('args') or {}).get('trace_ids') or ())]
    names = {e['name'] for e in mine}
    if not {'admission', 'model', 'd2h', 'save'} <= names:
        fail(f'{where}: the merged trace covers the request with '
             f'{sorted(names)}, want admission, model, d2h and save')
    span = [e for e in mine if e.get('ph') == 'X']
    print(f'{where}: merged trace, {len(mine)} events of the request '
          f'({sorted(names)}) over '
          f'{(max(e["ts"] + e["dur"] for e in span) - min(e["ts"] for e in span)) / 1e6:.3f} s; '
          f'{len(children)} farm worker(s) gone, /dev/shm clean', flush=True)
    return endpoint_s, first_wall


def serve_phase(torch, np, corr_lookup, gru, check_counts, card: str) -> None:
    """The warm-pool daemon on the card: an in-process ExtractionServer
    with the fused I3D configuration answers three requests over its
    loopback socket, then a sustained stream against the per-video loop;
    then a daemon started from the command line, without and with its
    pre-warm."""
    import multiprocessing

    from video_features_torch.config import load_config
    from video_features_torch.extract.i3d import ExtractI3D
    from video_features_torch.registry import create_extractor
    from video_features_torch.serve.client import ServeClient
    from video_features_torch.serve.server import ExtractionServer
    os.environ['VFT_RAFT_LOOKUP'] = 'auto'
    root = ROOT / 'output' / 'serve'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    paths = write_clips(np, root, SERVE_CLIPS, seed=23)
    stream_paths = write_clips(np, root, STREAM_CLIPS, seed=231)
    missing = str(root / 'missing.avi')
    shm_before = set(os.listdir('/dev/shm'))
    steps = [0]
    packed_step = ExtractI3D.packed_step
    width = 2048

    def counted_step(self, x):
        steps[0] += 1
        return packed_step(self, x)

    def counted(where, run):
        """``run()`` with the counts set to 0 just before and read just
        after: its result and its fused steps."""
        reset_counts(corr_lookup, gru)
        steps[0] = 0
        out = run()
        torch.cuda.synchronize()
        check_counts(read_counts(corr_lookup, gru), 'masked', steps[0], where)
        return out, steps[0]

    def check_shapes(tree, clip_paths, windows, where):
        for p, n in zip(clip_paths, windows):
            out = tree.get(Path(p).stem + '.npy')
            if out is None or out.shape != (n, width) \
                    or not np.isfinite(out).all():
                fail(f'{where}: {Path(p).name} gave '
                     f'{None if out is None else out.shape}, want ({n}, '
                     f'{width}), finite')

    ExtractI3D.packed_step = counted_step
    server = None
    try:
        server = ExtractionServer(base_overrides={**serve_base(root),
                                                  **SERVE_OBS}).start()
        client = ServeClient(port=server.port)
        results = {}
        for name, req_paths, out in (
                ('1 (cold)', paths[:2], 'r1'), ('2 (warm)', paths[:2], 'r2'),
                ('3 (a missing path)', [paths[2], missing], 'r3')):
            reset_counts(corr_lookup, gru)
            steps[0] = 0
            st, wall = serve_request(client, req_paths, str(root / out))
            torch.cuda.synchronize()
            counts = read_counts(corr_lookup, gru)
            windows = sum(SERVE_WINDOWS[paths.index(p)] for p in req_paths
                          if p in paths)
            print(f'phase 23 (a) request {name} [{card}]: {st["state"]}, '
                  f'{wall:.3f} s wall, {windows} windows, {steps[0]} fused '
                  f'steps at batch {PACK_BATCH}, launches {counts}',
                  flush=True)
            check_counts(counts, 'masked', steps[0],
                         f'phase 23 (a) request {name}')
            results[name] = (st, wall, windows)
        st1, st3 = results['1 (cold)'][0], results['3 (a missing path)'][0]
        if st1['state'] != 'done' or results['2 (warm)'][0]['state'] != 'done':
            fail(f'phase 23 (a): requests 1 and 2 ended {st1}, '
                 f'{results["2 (warm)"][0]}')
        if st3['state'] != 'partial' or st3['videos'] != {
                paths[2]: 'saved', missing: 'failed'}:
            fail(f'phase 23 (a): request 3 ended {st3}, want the missing '
                 'path failed alone')
        m = client.metrics()
        if (m['warm_pool']['builds_compiled'], m['warm_pool']['misses']) != (1, 1):
            fail(f'phase 23 (a): {m["warm_pool"]} (want one extractor build)')
        trees = {t: tree_arrays(np, str(root / t)) for t in ('r1', 'r2')}
        if compare_trees(np, trees['r1'], trees['r2'], 'phase 23 r1 vs r2'):
            fail('phase 23 (a): requests 1 and 2 are not byte-equal')
        check_shapes(trees['r1'], paths[:2], SERVE_WINDOWS[:2], 'phase 23 (a)')
        check_shapes(tree_arrays(np, str(root / 'r3')), paths[2:],
                     SERVE_WINDOWS[2:], 'phase 23 (a)')

        # the per-video loop on the same clips and weights, for the bytes
        ex = create_extractor(load_config('i3d', overrides={
            **serve_base(root), 'video_paths': paths[:2],
            'output_path': str(root / 'pv')}))
        counted('phase 23 per-video loop',
                lambda: [ex._extract(p) for p in paths[:2]])
        worst = compare_trees(np, tree_arrays(np, str(root / 'pv')),
                              trees['r1'], 'phase 23 per-video vs served')
        print(f'phase 23 (a): served requests 1 and 2 byte-equal; the '
              f'per-video loop against them '
              + ('byte-equal' if not worst else f'rel L2 {worst:.3e}'),
              flush=True)
        cold, warm = results['1 (cold)'][1], results['2 (warm)'][1]
        print(f'phase 23 (b) [{card}]: request wall cold {cold:.3f} s, warm '
              f'{warm:.3f} s (one request each)', flush=True)

        # (b) a sustained stream: rounds in the order server, loop, loop,
        # server, each over the whole corpus
        def loop_round(out):
            ex.output_path = out
            t0 = time.perf_counter()
            for p in stream_paths:
                ex._extract(p)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        corpus = sum(STREAM_WINDOWS)
        rates = {'server': [], 'loop': []}
        latencies = []
        for i, kind in enumerate(('server', 'loop', 'loop', 'server')):
            out = str(root / f'stream{i}_{kind}')
            where = f'phase 23 (b) stream round {i + 1} ({kind})'
            if kind == 'server':
                (wall, lat, states), n_steps = counted(
                    where, lambda: serve_stream(client, stream_paths, out))
                if set(states) != {'done'}:
                    fail(f'{where}: states {sorted(set(states))}')
                latencies += lat
            else:
                wall, n_steps = counted(where, lambda: loop_round(out))
            rates[kind].append(corpus / wall)
            print(f'{where} [{card}]: {len(stream_paths)} clips, {corpus} '
                  f'windows in {wall:.3f} s, {n_steps} fused steps: '
                  f'{corpus / wall:.3f} windows/s', flush=True)
        streams = {i: tree_arrays(np, str(root / f'stream{i}_{kind}'))
                   for i, kind in ((0, 'server'), (1, 'loop'), (3, 'server'))}
        check_shapes(streams[0], stream_paths, STREAM_WINDOWS,
                     'phase 23 (b) stream')
        worst = max(compare_trees(np, streams[0], streams[3],
                                  'phase 23 (b) server rounds 1 vs 4'),
                    compare_trees(np, streams[1], streams[0],
                                  'phase 23 (b) loop vs server'))
        server_rate = sum(rates['server']) / 2
        loop_rate = sum(rates['loop']) / 2
        print(f'phase 23 (b) [{card}]: sustained stream, {server_rate:.3f} '
              f'windows/s through the server (rounds '
              f'{", ".join(f"{r:.3f}" for r in rates["server"])}) against '
              f'{loop_rate:.3f} through the per-video loop (rounds '
              f'{", ".join(f"{r:.3f}" for r in rates["loop"])}): '
              f'{server_rate / loop_rate:.3f}x; outputs '
              + ('byte-equal' if not worst else f'within rel L2 {worst:.3e}'),
              flush=True)
        print(f'phase 23 (b) [{card}]: latency of the {len(latencies)} stream '
              f'requests (all of a round submitted at once): p50 '
              f'{nearest_rank(latencies, 0.5):.4f} s, p90 '
              f'{nearest_rank(latencies, 0.9):.4f} s, max '
              f'{max(latencies):.4f} s', flush=True)
        del ex, streams
        torch.cuda.empty_cache()
        busy, n_steps = counted('phase 23 (b) traced stream round', lambda: busy_share(
            torch, lambda: serve_stream(client, stream_paths,
                                        str(root / 'stream_traced'))))
        print(f'phase 23 (b) [{card}]: device busy '
              + ('not measured (the profiler recorded no device activity)'
                 if busy is None else f'{busy:.1%} of a traced stream '
                 f'round\'s wall ({n_steps} fused steps)'), flush=True)

        # (c) the watchdog and the SLOs
        m = client.metrics()
        wd, slo = m['watchdog'], m['slo']
        if not wd['enabled'] or wd['stalls_total'] != 0:
            fail(f'phase 23 (c): watchdog {wd}')
        if not slo['enabled'] or set(slo['burn_rates']) != {
                'latency', 'availability'}:
            fail(f'phase 23 (c): slo section {slo}')
        prom = client.metrics_prom()
        families = {ln.split()[2] for ln in prom.splitlines()
                    if ln.startswith('# TYPE ')}
        want = {'vft_serve_requests_total', 'vft_serve_request_latency_seconds',
                'vft_serve_queue_depth', 'vft_slo_latency_burn_rate',
                'vft_slo_availability_burn_rate', 'vft_slo_alert',
                'vft_watchdog_enabled'}
        if not want <= families:
            fail(f'phase 23 (c): metrics_prom lacks {sorted(want - families)}')
        print(f'phase 23 (c): watchdog stalls 0 over {len(wd["workers"])} '
              f'row(s); slo burn rates {slo["burn_rates"]}, alerts '
              f'{slo["alerts"]}; {len(families)} Prometheus families',
              flush=True)
        server.drain(wait=True, grace_s=300)
        server = None
    finally:
        ExtractI3D.packed_step = packed_step
        if server is not None:
            server.drain(wait=True, grace_s=60)
    left = sorted(set(os.listdir('/dev/shm')) - shm_before)
    children = multiprocessing.active_children()
    if left or children:
        fail(f'phase 23: left behind: /dev/shm {left}, processes {children}')
    cold_up, cold_first = serve_subprocess_phase(root, paths, card, False)
    warm_up, warm_first = serve_subprocess_phase(root, paths, card, True)
    print(f'phase 23 (d) [{card}]: serve_prewarm=i3d took the first '
          f'request from {cold_first:.3f} s to {warm_first:.3f} s '
          f'({cold_first - warm_first:.3f} s saved) and the endpoint line '
          f'from {cold_up:.3f} s to {warm_up:.3f} s after the start',
          flush=True)
    shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not (ROOT / 'video_features_torch' / 'csrc').is_dir():
        fail(f'video_features_torch/ not found beside {__file__}: run from '
             'a checkout of the repository')
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke run needs a GPU')

    t = phase('device')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} device {kind}',
          flush=True)

    from video_features_torch.extract.i3d import ExtractI3D, fused_two_stream_step
    from video_features_torch.extract.r21d import ExtractR21D
    from video_features_torch.extract.raft import ExtractRAFT
    from video_features_torch.extract.s3d import ExtractS3D
    from video_features_torch.io.video import batch_frames
    from video_features_torch.models import raft as raft_model
    from video_features_torch.models.raft import pad_amounts
    from video_features_torch.ops import _kernels, corr_lookup, gru, transforms
    from video_features_torch.utils.device import set_precision
    # precision=highest's flags for the phases' direct calls (plain
    # versions, card vs CPU); every extractor step sets its own lane's
    set_precision('highest')

    t = phase('build')
    from tools import gru_tf32x3_variants as variants
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        # the one-pass yardstick of phase 19 (a), built beside the kernels
        pr14_job = pool.submit(variants.build, 'pr14_one_pass')
        built = list(pool.map(_kernels.build, KERNELS))
        pr14 = pr14_job.result()[0]
    for name, (path, log) in zip(KERNELS, built):
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line or 'entry function' in line:
                print(f'  ptxas {name}:', line.strip())
        print(f'built {path.name}', flush=True)
    hgmma = sass_count(built[KERNELS.index('gru_direction')][0], 'HGMMA')
    print(f'gru_direction SASS: {hgmma} HGMMA instructions', flush=True)
    if not hgmma:
        fail('the GRU kernel was built without tensor-core (HGMMA) instructions')
    print(f'build phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('kernels')
    rec = kernel_phase(torch, F, corr_lookup)
    rec['gru'] = gru_phase(torch, gru)
    print(f'kernels phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('slice (I3D)')
    ex = ExtractI3D({
        'feature_type': 'i3d', 'streams': None, 'flow_type': 'raft',
        'stack_size': STACK, 'step_size': STACK, 'raft_iters': SLICE_ITERS,
        'concat_rgb_flow': True, 'batch_size': SLICE_BATCH, 'device': 'cuda',
        'precision': 'highest', 'allow_random_weights': True,
        'on_extraction': 'save_numpy', 'output_path': str(ROOT / 'output'),
    })
    windows = (FRAMES - (STACK + 1)) // STACK + 1
    steps = math.ceil(windows / SLICE_BATCH)
    launches = {'masked': 0, 'padded': 0, 'gru': 0, 'gru1': 0}

    def check_counts(counts, lookup_key, steps, where):
        want = {lookup_key: steps * SLICE_ITERS, 'gru': 2 * steps * SLICE_ITERS}
        for key, n in want.items():
            if counts[key] != n:
                fail(f'{where}: kernel {key} launched {counts[key]} times on '
                     f'the path, want {n} (lookup once and GRU twice per '
                     f'RAFT iteration)')
        for key in launches:
            launches[key] += counts[key]

    for key, env in (('masked', 'auto'), ('padded', 'pallas')):
        counts = slice_phase(torch, np, ex, corr_lookup, gru, env)
        check_counts(counts, key, steps, f'I3D slice, VFT_RAFT_LOOKUP={env}')
    print(f'slice phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('slice (RAFT family)')
    os.environ['VFT_RAFT_LOOKUP'] = 'auto'
    rex = ExtractRAFT({
        'feature_type': 'raft', 'batch_size': RAFT_BATCH,
        'raft_iters': SLICE_ITERS, 'finetuned_on': 'sintel', 'device': 'cuda',
        'precision': 'highest', 'allow_random_weights': True,
        'on_extraction': 'save_numpy', 'output_path': str(ROOT / 'output')})
    counts = raft_slice_phase(torch, np, rex, batch_frames, corr_lookup, gru)
    check_counts(counts, 'masked', math.ceil((RAFT_FRAMES - 1) / RAFT_BATCH),
                 'RAFT family slice')
    print(f'raft family phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('kernels vs plain on the slices')
    for env in ('auto', 'pallas'):
        os.environ['VFT_RAFT_LOOKUP'] = env
        plain_phase(torch, np, ex, fused_two_stream_step, pad_amounts)
    os.environ['VFT_RAFT_LOOKUP'] = 'auto'
    raft_plain_phase(torch, np, rex, raft_model)
    step_timing(torch, np, ex, fused_two_stream_step, pad_amounts)
    print(f'plain phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('device resize')
    resize_phase(torch, np, transforms)
    print(f'device resize phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('slice (R(2+1)D)')
    r21d_ex, r21d34_ex = r21d_phase(torch, np, ExtractR21D, corr_lookup, gru)
    print(f'r21d phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('slice (S3D)')
    s3d_ex = s3d_phase(torch, np, ExtractS3D, corr_lookup, gru)
    print(f's3d phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('I3D with device_resize=true')
    counts = device_resize_phase(torch, np, ex, transforms, corr_lookup, gru)
    check_counts(counts, 'masked', steps, 'I3D slice, device_resize=true')
    print(f'device_resize phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('card vs CPU')
    card_vs_cpu_phase(torch, np, r21d_ex, s3d_ex)
    print(f'card vs CPU phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('timing (R(2+1)D, S3D)')
    family_timing(torch, np, r21d_ex, r21d34_ex, s3d_ex)
    print(f'timing phase {time.perf_counter() - t:.1f} s', flush=True)
    del r21d_ex, r21d34_ex, s3d_ex

    t = phase('frame-wise (ResNet, CLIP)')
    framewise_phase(torch, np, corr_lookup, gru)
    print(f'frame-wise phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('timm (ViT-B/16 and one arch of every family)')
    timm_phase(torch, np, corr_lookup, gru)
    print(f'timm phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase(f'timm long tokens (ViT-B/16 at image_size {TIMM_LONG_SIZE})')
    timm_long_phase(torch, np, F, corr_lookup, gru)
    print(f'timm long-token phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('vggish (audio, through load_config and create_extractor)')
    vggish_phase(torch, np, corr_lookup, gru)
    print(f'vggish phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('streaming and packed loops (I3D at batch 8, resnet50 at batch 32)')
    packing_phase(torch, np, corr_lookup, gru, check_counts)
    print(f'packing phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('decode farm and fused worklists (I3D at batch 8; resnet50, '
              'CLIP and ViT-B/16 at batch 32)')
    farm_phase(torch, np, corr_lookup, gru, check_counts)
    print(f'farm phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('precision lanes (the one-pass GRU kernel; I3D and RAFT under '
              'highest, high and tensorfloat32; the bf16 and int8 lanes; the '
              'device resize under TF32)')
    gru_built = built[KERNELS.index('gru_direction')]
    rec['gru1'] = lanes_phase(torch, np, corr_lookup, gru, transforms, launches,
                              pr14, gru_built[1], gru_built[0])
    print(f'lanes phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('feature cache (I3D at batch 8 per video, packed through the '
              'decode farm, a second L1 over the L2, the GC; a fused '
              'frame-wise worklist)')
    cache_phase(torch, np, corr_lookup, gru, check_counts, card)
    print(f'cache phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('flight recorder (I3D at batch 8 per video with trace_out, '
              'manifest_out, postmortem_dir and profile_dir; packed through '
              'the decode farm; the recorder\'s cost)')
    flight_phase(torch, np, corr_lookup, gru, check_counts, card)
    print(f'flight recorder phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('several processes and devices (multihost over gloo, the mesh '
              'knobs, two shards on one card, sequence_parallel, two cards)')
    print(card, flush=True)
    parallel_phase(torch, np, corr_lookup, gru, check_counts)
    print(f'parallel phase {time.perf_counter() - t:.1f} s', flush=True)

    t = phase('serve (fused I3D): the warm-pool daemon on the card, in '
              'process and from the command line')
    print(card, flush=True)
    serve_phase(torch, np, corr_lookup, gru, check_counts, card)
    for key in launches:
        rec[key]['launches'] = launches[key]
    print(f'serve phase {time.perf_counter() - t:.1f} s', flush=True)

    kernels = []
    for key, name, source, replaces in (
            ('masked', 'corr_lookup_masked', 'corr_lookup.cu',
             'video_features_tpu/ops/pallas_corr.py:318'),
            ('padded', 'corr_lookup_padded', 'corr_lookup.cu',
             'video_features_tpu/ops/pallas_corr.py:162'),
            ('gru', 'gru_direction', 'gru_direction.cu',
             'tools/gru_kernel_experiment.py:154'),
            ('gru1', 'gru_direction_1xtf32', 'gru_direction.cu',
             'tools/gru_kernel_experiment.py:154')):
        r = rec[key]
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'video_features_torch/csrc/{source}',
            'replaces': replaces, 'launches': r['launches'],
            'max_abs_err': r['err'], 'ms': r['ms'], 'plain_ms': r['plain_ms'],
            'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
            'library_ms': r['library_ms']})
    # the 3xTF32 GRU row's bound is 3xTF32's; the fp32 FMA bound beside it
    kernels[2]['fp32_bound_ms'] = rec['gru']['fp32_bound_ms']
    # the one-pass row's same-call yardstick: the design before the cluster
    # kernel
    kernels[3]['pr14_one_pass_ms'] = rec['gru1']['pr14_one_pass_ms']
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
