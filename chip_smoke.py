#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

  python3 chip_smoke.py [--out DIR]

Builds the port's CUDA kernels from frame_interpolation_tpu_torch/csrc with
nvcc (one nvcc per source, in parallel) and holds each kernel against its
plain PyTorch version: the forward warp and the conv stacks at the shapes of
the 1080p serving path (the conv also at the train step's shapes, in TF32
and in exact f32), the warp's derivative planes and splat at the training
and 1080p shapes, the fusion decoder's upsampling kernel (nearest x2,
TF-SAME pad and the 2x2 conv in one) at the three sites of a 1080p bf16
midpoint and the finest site of a UHD f32 pair in TF32, and the flow
estimators' and the decoder's 3x3 conv kernel (the input's pieces, bias
and leaky relu in one) at every distinct site of a 1080p bf16 midpoint
and of a UHD midpoint in TF32, each also against the library ops it
replaces, and on UHD slices in TF32 against f64 on rounded operands, one
for each tile plan the UHD sites take; an eager 1080p midpoint under the
profiler must run that kernel at all 50 of its sites and no cuDNN conv
inside one. Each timed check gives the
kernel's time, the plain
version's, one PyTorch library call's where one computes the same function
(`library_ms`: F.grid_sample for the warp, the image gradient of its
backward for the splat, F.conv2d with bias through cuDNN for the conv,
which leaves out the activation and the pool, the upsample, the pad
and cuDNN's 2x2 conv for the upsampling kernel, and cuDNN's conv a piece
with the bias, the partial outputs' sum and the leaky relu for the 3x3
pieces kernel), and the
least time the card could take (`bound_ms`: the larger of the FLOPs over
the dtype's peak and the compulsory bytes over 3.35 TB/s). Then it drives
the port's two paths:

  * serving: three 1080p pair requests through the Interpolator (released
    config, bf16 policy, seeded random weights), checked for shape,
    finiteness, repeatability, the launch counts, and agreement with the
    same forward through the plain versions;
  * training (film_net-L1: released config, f32, batch 8 of 256x256
    moving-square triplets): one train step's loss and gradients against
    the same step through the plain versions (TF32 and cuDNN off), with
    every parameter's gradient finite and non-zero; the launch counts of one
    step; steps/s with the kernels and plain; then `train_lib.train` for
    20 steps with the augmentations and a resume to 25, checked for finite
    losses, checkpoints written and restored, and an export that the
    Interpolator loads; `cli.build_params` turns the run's newest
    checkpoint into a bundle whose forward must equal the trained model's;
  * the JAX package's bundle: the serving model written as options.json +
    params.msgpack (io/params_io.save_params), decoded on the host
    (io/msgpack_lite) and served through load_interpolator, held against
    the direct Interpolator;
  * a TF release of the reference: the serving model written in TF's
    layout by write_tf_checkpoint (the released files are not in the
    repository) as a tf.train.Checkpoint directory (with save_counter and
    an Adam slot, which the import skips) and as a SavedModel's variables
    (with a placeholder saved_model.pb that nothing parses), each read
    back without TensorFlow (io/tf_import, io/tf_bundle) to a state_dict
    bit-equal to the model's, served through load_interpolator against
    the direct Interpolator with the pair's launch counts, and converted
    by cli.build_params --tf_model; the host's write and read seconds
    and MB/s beside the JAX bundle's decode; cli.verify_released on the
    checkpoint form with two seeded 1080p frames must pass, its TF checks
    skipped (no SavedModel there, and this host has no TensorFlow);
  * training film_net-Style (the same step with l1 + vgg + style at step
    1,500,001, where vgg weighs 0.25 and style 40; VGG-19 to conv5_2 at its
    true widths, seeded random weights written as a MatConvNet .mat, since
    the released one is not in the repository): parity as for L1, launch
    counts, steps/s with the kernels and plain, the losses' share of a
    step; then `train_lib.train` of an inline film_net-Style gin file
    (training/configs/gin_compat) for 16 steps with the profiler's trace
    window, whose trace of steps [10, 15) must name the conv, warp and
    splat kernels.

Between serving and training it drives the video slice through the same
kernels, then the sharded serving paths, and after training the eval loop:

  * the exact uint8 rules on the card: u8 -> f32 of all 256 byte values
    bit for bit against numpy's v / 255, and the device quantization of a
    1080p frame against io.images.to_uint8;
  * the frame tree of 3 1080p uint8 frames at T = 3 (17 frames, bf16
    policy): the feature-cached DFS (f32 and uint8 out) and the chunked
    tree (max_batch 3), each with its launch counts, held against each
    other (PSNR), the uint8 output against the host's quantization, the
    kernels against the plain versions, and the streaming driver against
    the frontier; ms per output frame on the device and peak memory per
    route;
  * the tiled tree of a 1080p pair (2x2 patches, T = 1) against the tiled
    pair forward;
  * sharded serving on meshes that repeat the card (parallel/): the
    row-sharded 1080p pair (SpatialShardedInterpolator on [cuda:0] * 4 and
    * 2, and over every GPU where there are more) against the
    single-device Interpolator, with the launch counts the split levels
    predict; the 2x2 patches of a pair over 4 shards (ShardedInterpolator)
    against the tiled pair; the 17-frame tree over 4 shards
    (ShardedVideoInterpolator) against the chunked tree; ms and peak
    memory of each;
  * the eval loop (released config, f32, two 256x448 triplets; metrics
    l1, l2, ssim, psnr and the L1 training loss), kernels against plain
    with TF32 and cuDNN off, and its ms per example.

Then the slice that completes the port:

  * the split-concat convs (Options.split_convs): the 1080p bf16 pair split
    against concat (>= 50 dB, 12/20/14/48 launches in both forms, ms a pair
    of each in turns, the form 'auto' picks on CUDA), the pair in f32 at
    544x960 (1e-4) and under TF32 against the plain versions (60 dB), one
    film_net-L1 step in each form under the
    step-parity bounds, the row-sharded pair with split convs on
    [cuda:0] * 2 against one device;
  * the native CRC (native/, built with cc on this host): crc32c, its
    mask and the TFRecord scan against the Python loop on 64 MiB of
    seeded bytes and on a TFRecord of them the port's writer wrote, MB/s
    of both (a JSON line of its own before the kernels' line);
  * the dataset builders: cli.create_middlebury_tfrecord on a seeded
    1080p Middlebury-layout tree (4 clips, 2 shards), read back and
    evaluated on the card against the same frames from memory (needs PIL;
    where it does not import, a line says so and the phase does not run);
  * data-parallel training (parallel/distributed.py): two ranks sharing
    cuda:0 over gloo (subprocesses of this script, batch 4 each) against
    one process at batch 8 over 3 steps with the augmentations, launches
    a step and rank, steps/s of both; world size 1 over NCCL against the
    step without a group; one rank a card over NCCL where there are
    several GPUs.

The warp's row mode (B1-rows: a slab of output rows read from a table
of the frame's slabs, as the row-sharded forward runs it) is held bit
for bit against the whole-frame warp's rows, and against its plain
version, at 1088x1920x67 and x64 bf16 and 544x960x195 f32 over 2 and 4
slabs, under the seam flow and the seam flow moved a third of the frame
down. Its slice mode (B1-slice: the warp into a slice of channels of the
fusion's input) is held at the fusion's level-0 slices of a 1080p pair
(1088x1920x64 at channels 0 and 64 and x3 at 128 and 131 of a 144-channel
bf16 buffer, timed, against the plain warp and F.grid_sample each copied
into the slice) and in f32 at the coarsest level's: bit for bit against
the contiguous warp, within the warp's bound of the plain warp, every
channel outside the slice keeping its sentinel.

Every path above takes the port's default on the card: its entry points
run as captured CUDA graphs (utils/programs.py), so the serving, video,
sharded, split and training phases count their launches through the
replays; a check that swaps in the plain versions runs an eager
(graphs=False) Interpolator or step of the same model, as the plain
versions replace the kernels only where Python launches them. After the
gin loop, the graph phase holds each captured entry point against
graphs=False on the same weights and inputs:

  * the 1080p bf16 pair (released config): max-abs and PSNR of the replay
    against eager, launches through the replay accounting, ms a pair of
    each in turns, idle shares under torch.profiler, the first call's
    seconds, the capture's and the pool's bytes;
  * one default Interpolator serving pairs of mixed frame and batch sizes:
    each against eager, and the device memory its graphs hold, bounded by
    the pool's budget;
  * the 17-frame cached tree (3 uint8 1080p frames, T = 3): PSNR, ms per
    output frame, peak memory and the programs' pools;
  * the film_net-L1 and film_net-Style steps (f32, batch 8 of 256x256,
    the augmentations, TF32 allowed): from one state, the replayed step's
    loss and gradients against the eager step's, Adam's update given the
    replay's gradients against the eager update and a plain
    (non-capturable) Adam's; steps/s, peak memory and
    idle share of each; train_lib.train for 10 steps (logging at 5) with
    and without graphs, losses tracked;
  * the summary step as its own program in the lean step's pool: from
    one state against the eager summary step (the step bounds), its
    images equal, the pool's bytes of each variant;
  * determinism: under torch.use_deterministic_algorithms(True) (cuDNN's
    deterministic algorithms), two replayed film_net-L1 graph steps from
    one state bit-equal in the loss, the gradients and the parameters,
    and two film_net-Style steps; steps/s with and without the mode, and
    the splat's device ms a step in each; two film_net-L1 steps from the
    same state in the default mode, reported and not gated: bit-equal or
    not, the parameters whose gradients differ, and then two with cuDNN's
    deterministic switch alone;
  * the patch-sharded pair on [cuda:0] * 4 with and without graphs, and
    the row-sharded pair on [cuda:0] * 2 and * 4 as one program: >= 50 dB
    against one device, max-abs against its eager path, the launches, no
    host sync in a replayed call (set_sync_debug_mode('error')), ms a
    pair both ways in turns.

The 1080p pair's check also holds the all-outputs program (every output
of the forward) against eager, max-abs 0; the eval phase holds its
program against eager (1e-4) and times both over 10 batches; the
world-size-1 NCCL step is captured, under deterministic mode, and must
equal one process's captured step bit for bit. The splat sums in a
fixed order, its one route: at each of its shapes and flows two launches
must be bit-equal in the default mode, and at four small shapes with seam
and out-of-bounds flows, f32 and bf16, it must equal its ordered
reference (warp.splat_fixed_order_plain) bit for bit.
`--kernels_only` stops after the kernels' checks.

Each phase prints its lines; the second-to-last line is the per-kernel JSON
record and the last line is {"ok": true, "device": {...}}. Any failed check
exits non-zero before that line. Needs a GPU: without one it exits non-zero
and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time

# cuBLAS gives reproducible results only with a fixed workspace, which it
# reads when its first handle is made: the determinism phases need it, and
# the data-parallel ranks this script starts inherit it.
os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')

import numpy as np
import torch

from frame_interpolation_tpu_torch import losses as losses_lib
from frame_interpolation_tpu_torch import native
from frame_interpolation_tpu_torch.cli import (build_params,
                                               create_middlebury_tfrecord,
                                               verify_released)
from frame_interpolation_tpu_torch.data import dataset as dataset_lib
from frame_interpolation_tpu_torch.data import records, tfrecord
from frame_interpolation_tpu_torch.inference import (Interpolator,
                                                     cached_tree,
                                                     interpolator as
                                                     interpolator_lib,
                                                     load_interpolator,
                                                     recursion)
from frame_interpolation_tpu_torch.io import (images, params_io, tf_bundle,
                                             tf_import)
from frame_interpolation_tpu_torch.losses import vgg19
from frame_interpolation_tpu_torch.models import (create_model, init_params,
                                                  layers)
from frame_interpolation_tpu_torch.ops import (_kernels, conv3x3_pieces,
                                              conv_stack, conv_weights,
                                              resize, upconv2x2, warp)
from frame_interpolation_tpu_torch.options import Options
from frame_interpolation_tpu_torch.parallel import distributed
from frame_interpolation_tpu_torch.parallel import inference as sharded
from frame_interpolation_tpu_torch.parallel import mesh as parallel_mesh
from frame_interpolation_tpu_torch.training import (configs, eval_lib,
                                                    metrics_lib, train_lib)
from frame_interpolation_tpu_torch.training.configs import gin_compat
from frame_interpolation_tpu_torch.utils import measure, programs

WARP_BF16_BOUND = 2 * 2.0**-8  # max-abs, images in [0, 1)
WARP_F32_BOUND = 1e-5          # max-abs
WARP_SENTINEL = -7.0           # exact in bf16, outside the warp's [0, 1)
CONV_BF16_BOUND = 1e-2         # max|k - p| / max|p|
CONV_F32_BOUND = 1e-4          # same, TF32 off on the plain side
# Same, the kernel in TF32 against the plain version in exact f32: TF32
# keeps 10 of f32's 23 mantissa bits, so each product is off by up to
# about 2^-10 relative; over the sums of 576-4608 terms that leaves about
# 1e-3 of max|p|. Half the bf16 bound.
CONV_TF32_BOUND = 5e-3
# The kernel in TF32 against the plain version on its operands rounded to
# nearest TF32 (ties away, as cuDNN and cvt.rna.tf32.f32 round), TF32 off:
# products of TF32 values are exact in f32, so only the sums differ, and
# the tensor cores' accumulation drifts about 2.4e-9 a term of K = 9 Cin
# (1.4e-6 at K = 576, 1.07e-5 at 4608 on an H100). Relative RMS, bound
# twice that drift: at most 2.3e-5, where operands truncated instead of
# rounded read about 8e-4 at every K.
CONV_TF32_ROUNDED_BOUND_PER_K = 5e-9
PLANES_BF16_BOUND = 2 * 2.0**-8  # max-abs, images in [0, 1)
PLANES_F32_BOUND = 1e-5          # max-abs
SPLAT_BF16_BOUND = 1e-2        # max|k - p| / max|p|, bf16 cotangent
SPLAT_F32_BOUND = 1e-5         # same, f32 cotangent
PSNR_BOUND_DB = 30.0           # kernels vs plain versions, whole forward
REPEAT_BOUND = 1e-6            # max-abs between repeated requests
LOSS_REL_BOUND = 1e-5          # train step, kernels vs plain (TF32 off)
GRAD_REL_BOUND = 1e-3          # per tensor max|g_k - g_p| / max|g_p|
REQUESTS = 3
# Launches per 1080p pair (released config): 12 flow-estimator warps and
# 20 warps into the fusion's input (each frame's features and image at 5
# levels); per frame 7 C=64 second convs and 15 wider second convs + 9
# rectangular first convs, and each frame is extracted separately. None of
# the convs takes the TF32 route in bf16 (conv3x3_tf32; `under_tf32` gives
# an f32 run's counts while TF32 is allowed). The fusion decoder's three
# finer upsampling steps each run as one kernel (upconv2x2), and the 50
# 3x3 convs of the flow estimators (2 directions x 7 levels x 3) and the
# fusion (4 levels x 2) each as one kernel with its bias and leaky relu
# (conv3x3_pieces); `exact_f32` gives an f32 run's counts while TF32 is
# off, where both keep the library ops.
PAIR_LAUNCHES = {'warp': 12, 'warp_planes': 0, 'splat': 0,
                 'conv3x3_c64': 14, 'conv3x3_wide': 48, 'warp_rows': 0,
                 'warp_slice': 20, 'conv3x3_tf32': 0, 'upconv2x2': 3,
                 'conv3x3_pieces': 50}
# Launches per train step: the forward's, whose fusion input is the
# concat's (12 + 10 warps), plus one planes and one splat launch per warp
# in the backward (every warp's image and flow need a gradient); the conv
# backward is plain PyTorch, and the decoder's upsampling steps and the
# flow estimators' and the decoder's 3x3 convs are the library ops (no
# kernel there has a backward).
STEP_LAUNCHES = {'warp': 22, 'warp_planes': 22, 'splat': 22,
                 'conv3x3_c64': 14, 'conv3x3_wide': 48, 'warp_rows': 0,
                 'warp_slice': 0, 'conv3x3_tf32': 0, 'upconv2x2': 0,
                 'conv3x3_pieces': 0}
TRAIN_BATCH, TRAIN_CROP = 8, 256
TRAIN_STEPS, RESUME_STEPS, SAVE_INTERVAL = 20, 25, 10
WARMUP_STEPS, TIMED_STEPS = 3, 10
# film_net-Style: the step after its schedules' boundary (vgg 0.25, style
# 40); VGG-19's conv widths to conv5_2; the gin loop and its trace window.
STYLE_STEP = 1500001
VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
                512, 512)
GIN_STEPS, PROFILE_START, PROFILE_STEPS = 16, 10, 5
# Substrings of our kernels' names in a trace: the conv (TF32 wgmma), the
# warp and its planes (vector and run routes), the splat.
TRACE_KERNELS = ('conv3x3_wgmma_kernel', 'warp_', 'splat_tile_sum_kernel')
# film_net-Style.gin as the reference lays it out, the weights file
# filled in.
STYLE_GIN = '''
model.name = 'film_net'
film_net.pyramid_levels = 7
film_net.fusion_pyramid_levels = 5
film_net.specialized_levels = 3
film_net.sub_levels = 4
film_net.flow_convs = [3, 3, 3, 3]
film_net.flow_filters = [32, 64, 128, 256]
film_net.filters = 64
training.learning_rate = 0.0001
training.num_steps = 3000000
training_dataset.file = 'vimeo_interp_train.tfrecord@200'
training_dataset.batch_size = 8
training_dataset.crop_size = 256
data_augmentation.names = ['random_image_rot90', 'random_flip',
                           'random_rotate', 'random_reverse']
training_losses.loss_names = ['l1', 'vgg', 'style']
training_losses.loss_weight_schedules = [
    @tf.keras.optimizers.schedules.PiecewiseConstantDecay,
    @tf.keras.optimizers.schedules.PiecewiseConstantDecay,
    @tf.keras.optimizers.schedules.PiecewiseConstantDecay]
training_losses.loss_weight_parameters = [
    {'boundaries': [0], 'values': [1.0, 1.0]},
    {'boundaries': [1500000], 'values': [1.0, 0.25]},
    {'boundaries': [1500000], 'values': [0.0, 40.0]}]
test_losses.loss_names = ['l1', 'psnr', 'ssim']
test_losses.loss_weights = [1.0, 1.0, 1.0]
vgg.vgg_model_file = '{mat}'
style.vgg_model_file = '{mat}'
'''
# The video tree: 3 frames of 1080p, T = 3, so 17 frames and 14 midpoints.
VIDEO_FRAMES, VIDEO_TIMES, VIDEO_MAX_BATCH = 3, 3, 3
VIDEO_H, VIDEO_W = 1080, 1920
VIDEO_OUTPUTS = (VIDEO_FRAMES - 1) * 2**VIDEO_TIMES + 1
# The cached DFS: 12 + 20 warps a midpoint; 9 extractions (3 inputs + 6
# midpoints that are not final-depth leaves) of 7 C=64 and 24 wide convs.
CACHED_TREE_LAUNCHES = {'warp': 14 * 12, 'warp_planes': 0, 'splat': 0,
                        'conv3x3_c64': 9 * 7, 'conv3x3_wide': 9 * 24,
                        'warp_rows': 0, 'warp_slice': 14 * 20,
                        'conv3x3_tf32': 0, 'upconv2x2': 14 * 3,
                        'conv3x3_pieces': 14 * 50}
# The chunked tree at max_batch 3: 6 forwards (a batch of 2 at depth 1,
# 3+3 and 3+3+3 with filler pairs at depths 2 and 3); a launch covers the
# whole batch, so each forward launches a pair's 12/20/14/48.
CHUNKED_TREE_LAUNCHES = {k: 6 * v for k, v in PAIR_LAUNCHES.items()}
# The tiled tree of a pair at T = 1 in 2x2 patches: each patch's cached
# tree extracts its 2 frames and makes one midpoint.
TILED_TREE_LAUNCHES = {'warp': 4 * 12, 'warp_planes': 0, 'splat': 0,
                       'conv3x3_c64': 4 * 2 * 7, 'conv3x3_wide': 4 * 2 * 24,
                       'warp_rows': 0, 'warp_slice': 4 * 20,
                       'conv3x3_tf32': 0, 'upconv2x2': 4 * 3,
                       'conv3x3_pieces': 4 * 50}
# Sharded serving on one card, the pair padded to 1088x1920. Every shard
# runs every conv site (on its slab or the whole level), so 14n C=64 and
# 48n wide launches. A level splits when its rows divide into even slabs:
# over 4 shards the levels of 1088..136 rows (slabs 272..34), not 68 (17);
# over 2 the levels of 1088..68 rows, not 34. A shard warps a split level
# in row mode: the flow estimator warps levels 0-5 and the fusion levels
# 0-4, each in two directions, so over 4 shards 8 + 8 row-mode and 4 + 2
# whole warps a shard, over 2 shards 10 + 10 and 2 + 0. A shard builds the
# fusion's input by concats, so no warp into it, and its decoder runs the
# upsampling steps, and its flow estimators and decoder their 3x3 convs,
# as library ops.
SPATIAL_LAUNCHES = {
    4: {'warp': 4 * 6, 'warp_planes': 0, 'splat': 0, 'conv3x3_c64': 4 * 14,
        'conv3x3_wide': 4 * 48, 'warp_rows': 4 * 16, 'warp_slice': 0,
        'conv3x3_tf32': 0, 'upconv2x2': 0, 'conv3x3_pieces': 0},
    2: {'warp': 2 * 2, 'warp_planes': 0, 'splat': 0, 'conv3x3_c64': 2 * 14,
        'conv3x3_wide': 2 * 48, 'warp_rows': 2 * 20, 'warp_slice': 0,
        'conv3x3_tf32': 0, 'upconv2x2': 0, 'conv3x3_pieces': 0},
}
SHARDS = 4
# The 2x2 patches of a pair over 4 shards: each shard's one-patch forward
# launches a pair's 12/20/14/48.
SHARDED_PATCH_LAUNCHES = {k: SHARDS * v for k, v in PAIR_LAUNCHES.items()}
# The 17-frame tree over 4 shards, one node a shard: chunks of 4 nodes,
# 1 + 1 + 2 of them at depths 1-3 (2, 4 and 8 pairs), so 16 one-node
# forwards.
SHARDED_TREE_LAUNCHES = {k: 16 * v for k, v in PAIR_LAUNCHES.items()}
SPATIAL_PSNR_DB = 50.0         # sharded vs single device, whole output
TREE_PSNR_DB = 50.0            # per frame, the same model at other batches
UINT8_LEVELS = 1               # device uint8 vs host quantization, levels
# Eval means, kernels vs plain in exact f32 (TF32 and cuDNN off): the
# forward's outputs agree to about 1e-5 of their range (the conv's f32
# bound is 1e-4 of max|p| a site, and errors average out in the means),
# so each mean moves by about 1e-5 of its size: 1e-4 relative for l1, l2
# and the training loss; 1e-4 absolute for SSIM, whose value lies in
# [-1, 1] and may sit near 0; 1e-3 dB for PSNR (10 log10 of an mse that
# moves by 1e-4 relative is 4e-4 dB).
EVAL_REL_BOUND = 1e-4
EVAL_SSIM_BOUND = 1e-4
EVAL_PSNR_BOUND_DB = 1e-3
EVAL_BATCHES, EVAL_H, EVAL_W = 2, 256, 448
# Eval's timing: the same triplets repeated, so one program's warm-up and
# capture spread over a dataset's worth of replays.
EVAL_TIMED_BATCHES = 10
# Split-concat convs against the concat form: the 1080p bf16 pair (one
# more bf16 rounding of each partial output at 18 sites: the kernels vs
# plain bound), the pair in f32 at 544x960 with TF32 off (reassociation:
# the conv's f32 bound).
SPLIT_PSNR_DB = 50.0
SPLIT_F32_BOUND = 1e-4         # max-abs, images in [0, 1)
SPLIT_H, SPLIT_W = 544, 960
# The native CRC: 64 MiB of seeded bytes, as 64 records of 1 MiB.
CRC_BYTES, CRC_RECORD, CRC_REPEATS = 64 << 20, 1 << 20, 3
# The builders: 4 Middlebury-layout clips of 1080p in 2 shards, evaluated
# from the records and from memory: the same pixels (PNG is lossless), so
# the same means up to the eval's own run-to-run order.
BUILDER_CLIPS, BUILDER_SHARDS, BUILDER_BOUND = 4, 2, 1e-4
# Data-parallel: 3 parity steps (TF32 and cuDNN off) and steps/s over 5
# after 2; ranks at batch 4 sum in another order than one process at 8,
# which the step-parity bounds cover, and the 3-step losses drift by the
# updates' rounding.
DDP_STEPS, DDP_WARMUP, DDP_TIMED = 3, 2, 5
DDP_TRAJECTORY_BOUND = 1e-4
DDP_TIMEOUT_S = 600
# The graph phase: the port's entry points captured as CUDA graphs
# (utils/programs.py) against graphs=False on the same weights and
# inputs. The same kernels run in the same order, so the pair and the
# tree should agree bit for bit; the gates are the trees' and sharding's.
# Outside deterministic mode a train step is not promised the same bits on
# each run (cuDNN picks its algorithms freely there). From
# one state, copied into both sides after the capture, the replayed
# step's loss is held to the step-parity loss bound, its gradients to the
# step-parity gradient bound, and each side's parameters after its own
# step to 1e-5 relative of the other's; so is Adam's update given the
# replay's gradients. (From two states that differ by one step's noise,
# Adam's first, normalized updates make parameters whose gradient is near
# 0 differ by up to 1e-2 relative: the states must be one.) 10 steps of
# train_lib.train (a logging step, eager, at step 5 and the last) are
# held to 1e-3 of the all-eager run's losses.
GRAPH_PSNR_DB = 50.0
GRAPH_STEP_REL_BOUND = 1e-5
# (H, W, batch) of the pairs one Interpolator serves in turn: frame sizes
# and batch sizes whose graphs together outgrow the pool's budget. The
# first nine fit in it (the pool holds 17.62 GiB of its 19.79 after the
# 4K pair); the 4K pair at batch 2 takes the pool past it, and the
# capture of the next new key empties it.
MIXED_KEYS = ((1080, 1920, 1), (1080, 1920, 2), (1440, 2560, 1),
              (720, 1280, 1), (720, 1280, 3), (1080, 1920, 3),
              (2160, 3840, 1), (1080, 1920, 1), (720, 1280, 1),
              (2160, 3840, 2), (720, 1280, 2))
# Device memory beyond the pool's: the graphs' static inputs and the
# allocator's rounding.
MIXED_SLACK_BYTES = 2**30
GRAPH_TRACK_REL_BOUND = 1e-3
GRAPH_LOOP_STEPS, GRAPH_LOG_INTERVAL = 10, 5
GRAPH_PAIR_ITERS, GRAPH_IDLE_PAIRS, GRAPH_IDLE_STEPS = 10, 5, 5
# The flow estimators' and the decoder's 3x3 sites of a 1080p midpoint
# (the frame padded to 1088x1920), each distinct shape once: (H, W, the
# pieces' channels, Cout). The flow's levels 0-6 (both directions), then
# the fusion's conv_{i}_1 and conv_{i}_2 at levels 0-3.
PIECES_SITES = (
    (1088, 1920, (64, 64), 32), (1088, 1920, (32,), 32),
    (544, 960, (192, 192), 64), (544, 960, (64,), 64),
    (272, 480, (448, 448), 128), (272, 480, (128,), 128),
    (136, 240, (960, 960), 256), (136, 240, (256,), 256),
    (68, 120, (960, 960), 256), (68, 120, (256,), 256),
    (34, 60, (960, 960), 256), (34, 60, (256,), 256),
    (17, 30, (960, 960), 256), (17, 30, (256,), 256),
    (1088, 1920, (144, 64), 64), (1088, 1920, (64,), 64),
    (544, 960, (400, 128), 128), (544, 960, (128,), 128),
    (272, 480, (912, 256), 256), (272, 480, (256,), 256),
    (136, 240, (1936, 512), 512), (136, 240, (512,), 512))
# The same of a UHD midpoint (2160x3840 padded to 2176x3840), as
# pair-4k-f32 runs them in TF32: every level twice as tall and wide.
PIECES_SITES_UHD = tuple((2 * h, 2 * w, channels, cout)
                         for h, w, channels, cout in PIECES_SITES)
# UHD slices in TF32 whose f64 references on rounded operands take
# seconds: each picks a tile plan that the UHD sites take (the finest
# sites' 8 rows of N = 32 and 64; 4 rows of 128; 2 rows of 256, of 128 and
# of 64), with 16- and 48-channel tails (H, W, the pieces' channels, Cout).
PIECES_SLICES_TF32 = (
    (256, 512, (64, 64), 32), (256, 512, (32,), 32),
    (256, 512, (144, 64), 64), (64, 512, (448, 448), 128),
    (64, 512, (400, 128), 128), (32, 512, (960, 960), 256),
    (32, 512, (912, 256), 256), (16, 512, (1936, 512), 512),
    (68, 120, (960, 960), 256), (34, 60, (960, 960), 256),
    (34, 60, (1936, 512), 512))
# Kernels against plain versions, the f32 pair under TF32 (both sides'
# convs in TF32: the kernels' rounded operands against cuDNN's). It read
# 80.65 dB on the H100; a tile plan with wrong sums at one site reads far
# below.
TF32_PAIR_PSNR_DB = 60.0
REPLACES = {
    'warp': 'frame_interpolation_tpu/ops/warp_window.py:134',
    'warp_planes': 'frame_interpolation_tpu/ops/warp_window.py:134',
    'splat': 'frame_interpolation_tpu/ops/warp_splat.py:67',
    'conv3x3_c64': 'frame_interpolation_tpu/ops/conv_stack.py:141',
    'conv3x3_wide': 'frame_interpolation_tpu/ops/conv_stack_wide.py:124',
    'warp_rows': 'frame_interpolation_tpu/ops/warp_window.py:134',
    'warp_slice': 'frame_interpolation_tpu/ops/warp_window.py:134',
    'upconv2x2': 'none: frame_interpolation_tpu/models/fusion.py leaves the '
                 'upsampling step to XLA',
    'conv3x3_pieces': 'none: frame_interpolation_tpu/models/flow_estimator.py '
                      'and fusion.py leave these convs to XLA',
}
SOURCES = {
    'warp': 'frame_interpolation_tpu_torch/csrc/warp.cu',
    'warp_planes': 'frame_interpolation_tpu_torch/csrc/warp.cu',
    'splat': 'frame_interpolation_tpu_torch/csrc/splat.cu',
    'conv3x3_c64': 'frame_interpolation_tpu_torch/csrc/conv3x3.cu',
    'conv3x3_wide': 'frame_interpolation_tpu_torch/csrc/conv3x3.cu',
    'warp_rows': 'frame_interpolation_tpu_torch/csrc/warp.cu',
    'warp_slice': 'frame_interpolation_tpu_torch/csrc/warp.cu',
    'upconv2x2': 'frame_interpolation_tpu_torch/csrc/upconv2x2.cu',
    'conv3x3_pieces': 'frame_interpolation_tpu_torch/csrc/conv3x3_pieces.cu',
}


class CheckFailed(Exception):
  pass


def device_line() -> str:
  if not torch.cuda.is_available():
    raise CheckFailed('torch.cuda.is_available() is false: this smoke test '
                      'needs a CUDA GPU')
  return measure.card_line()


def add_timing(result, kernel_fn, plain_fn, library_fn, flops, nbytes, peak):
  """The four numbers of a timed check, all from this run and this card;
  the card queues each loop (measure.time_ms), so a kernel of a few
  microseconds is timed and not its launch."""
  result['ms'] = measure.time_ms(kernel_fn)
  result['plain_ms'] = measure.time_ms(plain_fn)
  result['library_ms'] = (None if library_fn is None else
                          measure.time_ms(library_fn))
  result.update(measure.roofline(flops, nbytes, peak))
  result['share'] = result['bound_ms'] / result['ms']


@contextlib.contextmanager
def tf32_allowed(allowed: bool):
  """Sets torch.backends.cudnn.allow_tf32, the flag the conv kernel's f32
  route follows (TF32 wgmma or exact FMAs), and restores it."""
  saved = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = allowed
  try:
    yield
  finally:
    torch.backends.cudnn.allow_tf32 = saved


def kernel_route(dtype: torch.dtype, tf32: bool) -> str:
  """The conv kernels' route for `dtype` with TF32 allowed or not."""
  with tf32_allowed(tf32):
    return conv_weights.route(dtype)


def under_tf32(launches):
  """The counts `launches` of an f32 run made while TF32 is allowed: every
  conv launch also takes the TF32 route (`conv3x3_tf32`)."""
  return dict(launches, conv3x3_tf32=launches['conv3x3_c64'] +
              launches['conv3x3_wide'])


def exact_f32(launches):
  """The counts `launches` of an f32 run made while TF32 is off: the
  decoder's upsampling steps and the flow estimators' and the decoder's 3x3
  convs keep the library ops (`upconv2x2`, `conv3x3_pieces`)."""
  return dict(launches, upconv2x2=0, conv3x3_pieces=0)


def smooth_seam_flow(h: int, w: int) -> torch.Tensor:
  """Smooth +-30 px flow plus a 40 px motion seam (the warp's hard case)."""
  yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
  flow = np.stack([30 * np.sin(yy / 97.0) * np.cos(xx / 131.0),
                   30 * np.cos(yy / 89.0) * np.sin(xx / 151.0)], axis=-1)
  flow[:, :w // 2] += 40.0
  return torch.from_numpy(flow[None].astype(np.float32)).cuda()


def check_warp(rng, h, w, c, dtype, bound, batch=1, timed=True):
  image = torch.from_numpy(rng.rand(batch, h, w, c).astype(np.float32)).to(
      'cuda', dtype)
  flow = smooth_seam_flow(h, w).expand(batch, h, w, 2).contiguous()
  got = warp.backward_warp_kernel(image, flow)
  want = warp.backward_warp_plain(image, flow)
  torch.cuda.synchronize()
  err = (got.float() - want.float()).abs().max().item()
  result = {
      'shape': f'{batch}x{h}x{w}x{c}', 'dtype': str(dtype).split('.')[-1],
      'max_abs_err': err, 'bound': bound, 'ok': err <= bound,
  }
  if timed:
    # F.grid_sample (bilinear, border, align_corners=True) on the same
    # channels-last image, its grid made from the flow beforehand.
    grid = measure.bilinear_grid(flow).to(dtype)
    nchw = image.permute(0, 3, 1, 2)
    nbytes = 2 * image.numel() * image.element_size() + flow.numel() * 4
    add_timing(result, lambda: warp.backward_warp_kernel(image, flow),
               lambda: warp.backward_warp_plain(image, flow),
               lambda: torch.nn.functional.grid_sample(
                   nchw, grid, mode='bilinear', padding_mode='border',
                   align_corners=True),
               # Three lerps a channel, 3 FLOPs each.
               9.0 * image.numel(), nbytes, measure.PEAK_FLOPS['float32'])
  return result


def check_warp_into(rng, h, w, c, pitch, channel, dtype, bound, timed=True):
  """B1-slice: the warp into channels [channel, channel + c) of a buffer of
  `pitch` channels filled with a sentinel, under the seam flow: the slice
  within `bound` of the plain warp and bit for bit the contiguous kernel's
  warp, every other channel still the sentinel. Timed against the plain
  warp copied into the slice and F.grid_sample with a copy into the slice;
  the bytes are the image and flow read and the slice written."""
  image = torch.from_numpy(rng.rand(1, h, w, c).astype(np.float32)).to(
      'cuda', dtype)
  flow = smooth_seam_flow(h, w)
  out = torch.full((1, h, w, pitch), WARP_SENTINEL, dtype=dtype,
                   device='cuda')
  warp.backward_warp_into_kernel(image, flow, out, channel)
  got = out[..., channel:channel + c]
  want = warp.backward_warp_plain(image, flow)
  contiguous = warp.backward_warp_kernel(image, flow)
  torch.cuda.synchronize()
  err = (got.float() - want.float()).abs().max().item()
  outside = torch.cat([out[..., :channel], out[..., channel + c:]], -1)
  kept = bool((outside == WARP_SENTINEL).all().item())
  bit_equal = torch.equal(got, contiguous)
  result = {
      'shape': f'1x{h}x{w}x{c} into {pitch} at {channel}',
      'dtype': str(dtype).split('.')[-1], 'max_abs_err': err, 'bound': bound,
      'sentinels_kept': kept, 'contiguous_bit_equal': bit_equal,
      'ok': err <= bound and kept and bit_equal,
  }
  if timed:
    grid = measure.bilinear_grid(flow).to(dtype)
    nchw = image.permute(0, 3, 1, 2)
    piece = out[..., channel:channel + c]

    def plain():
      piece.copy_(warp.backward_warp_plain(image, flow))

    def library():
      piece.copy_(torch.nn.functional.grid_sample(
          nchw, grid, mode='bilinear', padding_mode='border',
          align_corners=True).permute(0, 2, 3, 1))

    nbytes = 2 * image.numel() * image.element_size() + flow.numel() * 4
    add_timing(result,
               lambda: warp.backward_warp_into_kernel(image, flow, out,
                                                      channel),
               plain, library, 9.0 * image.numel(), nbytes,
               measure.PEAK_FLOPS['float32'])
  return result


def check_warp_rows(rng, h, w, c, dtype, bound, timed_cases):
  """B1-rows: the frame's rows as n in {2, 4} slabs, each its own tensor,
  and each shard's output rows warped by the kernel from the slabs' table
  of addresses, under the seam flow and under the seam flow moved by a
  third of the frame down (taps many slabs away): bit for bit against the
  whole-frame kernel's rows and within `bound` of the row-mode plain
  version. Timed for (n, flow) in `timed_cases`: all n shards' launches,
  against one F.grid_sample a shard on the whole frame and the bound of
  the bytes the shards' taps reach (each shard's output and flow, and the
  source rows between its lowest and highest tap)."""
  image = torch.from_numpy(rng.rand(1, h, w, c).astype(np.float32)).to(
      'cuda', dtype)
  flows = {'seam': smooth_seam_flow(h, w)}
  flows['far'] = (flows['seam'] + torch.tensor(
      [0.0, h / 3.0], device='cuda')).contiguous()
  results = []
  for flow_kind, flow in flows.items():
    full = warp.backward_warp_kernel(image, flow)
    for n in (2, 4):
      slab = h // n
      slabs = [image[:, d * slab:(d + 1) * slab].clone() for d in range(n)]
      cases = [(flow[:, d * slab:(d + 1) * slab].contiguous(), d * slab)
               for d in range(n)]

      def kernel():
        return [warp.backward_warp_rows_kernel(slabs, f, r, h)
                for f, r in cases]

      def plain():
        return [warp.backward_warp_rows_plain(slabs, f, r, h)
                for f, r in cases]

      got, want = kernel(), plain()
      torch.cuda.synchronize()
      full_err = max((g.float() - full[:, r:r + slab].float()).abs().max(
          ).item() for g, (_, r) in zip(got, cases))
      err = max((g.float() - p.float()).abs().max().item()
                for g, p in zip(got, want))
      result = {'shape': f'{h}x{w}x{c} n={n}', 'flow': flow_kind,
                'dtype': str(dtype).split('.')[-1], 'max_abs_err': err,
                'full_err': full_err, 'bound': bound,
                'ok': full_err == 0 and err <= bound}
      if (n, flow_kind) in timed_cases:
        nchw = image.permute(0, 3, 1, 2)
        grids = [measure.bilinear_grid(f, r, h).to(dtype) for f, r in cases]

        def library():
          return [torch.nn.functional.grid_sample(
              nchw, g, mode='bilinear', padding_mode='border',
              align_corners=True) for g in grids]

        nbytes = 0
        for f, r in cases:
          iy = warp.query_coords(h, w, f, r, 0, h)[0]
          reach = int(iy.max().item()) + 2 - int(iy.min().item())
          nbytes += ((f.shape[1] + reach) * w * c * image.element_size() +
                     f.numel() * 4)
        add_timing(result, kernel, plain, library, 9.0 * image.numel(),
                   nbytes, measure.PEAK_FLOPS['float32'])
      results.append(result)
  return results


def tf32_rounded(x: torch.Tensor) -> torch.Tensor:
  """f32 `x` rounded to nearest TF32 (11 significant bits), ties away from
  zero, by f64 arithmetic on the significand rather than by f32 bits."""
  mantissa, exponent = torch.frexp(x.double())
  scaled = mantissa * 2048.0
  kept = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)
  return torch.ldexp(kept / 2048.0, exponent).float()


def check_conv(rng, h, w, cin, cout, pool, dtype, bound, batch=1,
               timed=True, tf32=False):
  """The conv kernel against its plain version in exact f32 (TF32 off); the
  kernel and the library call run with TF32 allowed when `tf32`, and the
  kernel is then also held to the plain version on TF32-rounded operands
  (CONV_TF32_ROUNDED_BOUND_PER_K), which a kernel that truncates them
  fails."""
  x = torch.from_numpy(
      (rng.rand(batch, h, w, cin) * 2 - 1).astype(np.float32))
  x = x.to('cuda', dtype)
  std = (9.0 * cin)**-0.5
  weight = torch.from_numpy(
      (rng.randn(cout, cin, 3, 3) * std).astype(np.float32)).cuda()
  bias = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).cuda()

  def kernel():
    with tf32_allowed(tf32):
      return conv_stack.conv3x3_leaky_kernel(x, weight, bias, pool)

  def plain():
    return conv_stack.conv3x3_leaky_plain(x, weight, bias, pool)

  got, want = kernel(), plain()
  torch.cuda.synchronize()
  rel, err = 0.0, 0.0
  for g, p in zip(got, want):
    if p is None:
      continue
    diff = (g.float() - p.float()).abs().max().item()
    err = max(err, diff)
    rel = max(rel, diff / p.float().abs().max().item())
  kind = 'tf32' if tf32 and dtype == torch.float32 else str(dtype).split(
      '.')[-1]
  result = {
      'shape': f'{batch}x{h}x{w} {cin}->{cout}{"+pool" if pool else ""}',
      'dtype': kind,
      'route': conv_stack.kernel_symbol(kernel_route(dtype, tf32)),
      'max_abs_err': err, 'rel_err': rel, 'bound': bound, 'ok': rel <= bound,
  }
  if kind == 'tf32':
    rounded = conv_stack.conv3x3_leaky_plain(
        tf32_rounded(x), tf32_rounded(weight), bias, pool)
    rms = 0.0
    for g, p in zip(got, rounded):
      if p is None:
        continue
      diff = g.double() - p.double()
      rms = max(rms, (diff.square().sum() /
                      p.double().square().sum()).sqrt().item())
    del rounded
    rounded_bound = CONV_TF32_ROUNDED_BOUND_PER_K * 9 * cin
    result.update(rounded_rel_rms=rms, rounded_bound=rounded_bound,
                  ok=result['ok'] and rms <= rounded_bound)
  if timed:
    # F.conv2d with bias on channels-last tensors, through cuDNN: the conv
    # and bias only, without the activation and the pool.
    nchw = x.permute(0, 3, 1, 2)
    w_cl = weight.to(dtype).contiguous(memory_format=torch.channels_last)
    b_cl = bias.to(dtype)

    def library():
      with tf32_allowed(tf32):
        return torch.nn.functional.conv2d(nchw, w_cl, b_cl, padding=1)

    add_timing(result, kernel, plain, library,
               *measure.conv_cost(batch, h, w, cin, cout, pool,
                                  x.element_size()),
               measure.PEAK_FLOPS[kind])
  return result


def check_upconv(rng, n, h, w, cin, cout, dtype, timed=True):
  """The decoder's upsampling kernel (nearest x2, TF-SAME pad and the 2x2
  conv of an (n, h, w, cin) level) against its plain phases and against
  the library ops it replaces (`resize_nearest`, the layer's pad, cuDNN's
  conv). bf16: each within one bf16 ulp of the output's scale. f32, on
  the TF32 route: within the conv's TF32 bound of the plain phases in
  exact f32, and on TF32-rounded operands within its per-term drift."""
  conv = layers.Conv(cin, cout, 2, dtype).cuda()
  with torch.no_grad():
    conv.weight.copy_(torch.from_numpy(
        (rng.randn(cout, cin, 2, 2) * (4.0 * cin)**-0.5).astype(np.float32)))
    conv.bias.copy_(torch.from_numpy(
        (rng.randn(cout) * 0.1).astype(np.float32)))
  x = torch.from_numpy(
      (rng.rand(n, h, w, cin) * 2 - 1).astype(np.float32)).to('cuda', dtype)
  tf32 = dtype == torch.float32

  @torch.no_grad()
  def kernel():
    with tf32_allowed(tf32):
      return upconv2x2.upconv2x2_kernel(x, conv.weight, conv.bias)

  @torch.no_grad()
  def plain():
    return upconv2x2.upconv2x2_plain(x, conv.weight, conv.bias)

  @torch.no_grad()
  def library():
    with tf32_allowed(tf32):
      return conv(resize.resize_nearest(x, (2 * h, 2 * w)))

  got, want, lib = kernel(), plain(), library()
  torch.cuda.synchronize()
  scale = want.float().abs().max().item()
  err = (got.float() - want.float()).abs().max().item()
  lib_err = (got.float() - lib.float()).abs().max().item()
  if tf32:
    bound = CONV_TF32_BOUND
    ok = err <= bound * scale
  else:
    # One bf16 ulp at the output's largest magnitude.
    bound = 2.0**(np.floor(np.log2(scale)) - 7) / scale
    ok = err <= bound * scale and lib_err <= bound * scale
  result = {
      'shape': f'{n}x{h}x{w} {cin}->{cout} x2',
      'dtype': 'tf32' if tf32 else 'bfloat16',
      'route': upconv2x2.kernel_symbol(kernel_route(dtype, tf32)),
      'max_abs_err': err,
      'rel_err': err / scale, 'library_rel_err': lib_err / scale,
      'bound': bound, 'ok': ok,
  }
  if tf32:
    with torch.no_grad():
      rounded = upconv2x2.upconv2x2_plain(
          tf32_rounded(x).double(), tf32_rounded(conv.weight).double(),
          conv.bias.double())
    diff = got.double() - rounded
    rms = (diff.square().sum() / rounded.square().sum()).sqrt().item()
    rounded_bound = CONV_TF32_ROUNDED_BOUND_PER_K * 4 * cin
    result.update(rounded_rel_rms=rms, rounded_bound=rounded_bound,
                  ok=ok and rms <= rounded_bound)
    del rounded, diff
  del got, want, lib
  if timed:
    add_timing(result, kernel, plain, library,
               *measure.upconv_cost(n, h, w, cin, cout, x.element_size()),
               measure.PEAK_FLOPS[result['dtype']])
  return result


def check_pieces(rng, n, h, w, channels, cout, dtype, timed=True,
                 rounded=True):
  """The flow estimators' and the decoder's 3x3 conv kernel (the pieces of
  `channels`, bias, leaky relu) against its plain sums and against the
  library ops it replaces (cuDNN's conv a piece with the bias, the sum of
  the partial outputs, the leaky relu: `leaky_relu(Conv.conv(pieces))`,
  in TF32 on that route). bf16: within one bf16 ulp of the output's scale
  of the plain sums, and within the conv's bf16 bound of the library ops
  (which round each partial output). f32, on the TF32 route: within the
  conv's TF32 bound of the plain sums in exact f32, and with `rounded` on
  TF32-rounded operands within their per-term drift (f64 sums: seconds at
  a UHD slice, minutes at a whole UHD level). Reports the tile plan the
  kernel took (`tile_plan`)."""
  cin = sum(channels)
  conv = layers.Conv(cin, cout, 3, dtype).cuda()
  with torch.no_grad():
    conv.weight.copy_(torch.from_numpy(
        (rng.randn(cout, cin, 3, 3) * (9.0 * cin)**-0.5).astype(np.float32)))
    conv.bias.copy_(torch.from_numpy(
        (rng.randn(cout) * 0.1).astype(np.float32)))
  pieces = [torch.from_numpy((rng.rand(n, h, w, c) * 2 - 1).astype(
      np.float32)).to('cuda', dtype) for c in channels]
  weights = conv.weight.detach().split(list(channels), dim=1)
  tf32 = dtype == torch.float32
  x = pieces if len(pieces) > 1 else pieces[0]

  @torch.no_grad()
  def kernel():
    with tf32_allowed(tf32):
      return conv3x3_pieces.conv3x3_pieces_kernel(pieces, conv.weight,
                                                  conv.bias)

  @torch.no_grad()
  def plain():
    return conv3x3_pieces.conv3x3_pieces_plain(pieces, weights, conv.bias)

  @torch.no_grad()
  def library():
    with tf32_allowed(tf32):
      return layers.leaky_relu(conv.conv(x))

  got, want, lib = kernel(), plain(), library()
  torch.cuda.synchronize()
  scale = want.float().abs().max().item()
  err = (got.float() - want.float()).abs().max().item()
  lib_err = (got.float() - lib.float()).abs().max().item()
  if tf32:
    bound = CONV_TF32_BOUND
    ok = err <= bound * scale
  else:
    # One bf16 ulp at the output's largest magnitude, compared as it is (a
    # quotient by the scale and back may round it below one ulp).
    ulp = 2.0**(np.floor(np.log2(scale)) - 7)
    bound = ulp / scale
    ok = err <= ulp and lib_err <= CONV_BF16_BOUND * scale
  result = {
      'shape': f'{n}x{h}x{w} {"+".join(map(str, channels))}->{cout}',
      'dtype': 'tf32' if tf32 else 'bfloat16',
      'route': conv3x3_pieces.kernel_symbol(kernel_route(dtype, tf32)),
      'plan': conv3x3_pieces.tile_plan(n, h, w, cout),
      'max_abs_err': err, 'rel_err': err / scale,
      'library_rel_err': lib_err / scale, 'bound': bound, 'ok': ok,
  }
  if tf32 and rounded:
    with torch.no_grad():
      rounded = conv3x3_pieces.conv3x3_pieces_plain(
          [tf32_rounded(p).double() for p in pieces],
          [tf32_rounded(wt.contiguous()).double() for wt in weights],
          conv.bias.double())
    diff = got.double() - rounded
    rms = (diff.square().sum() / rounded.square().sum()).sqrt().item()
    rounded_bound = CONV_TF32_ROUNDED_BOUND_PER_K * 9 * cin
    result.update(rounded_rel_rms=rms, rounded_bound=rounded_bound,
                  ok=ok and rms <= rounded_bound)
    del rounded, diff
  del got, want, lib
  if timed:
    add_timing(result, kernel, plain, library,
               *measure.conv_cost(n, h, w, cin, cout, False,
                                  pieces[0].element_size()),
               measure.PEAK_FLOPS[result['dtype']])
  return result


def pieces_midpoint_ms(results, key):
  """`key` summed over a midpoint's 50 sites, from the results of
  PIECES_SITES in order: of the flow's (the first 14, a level's first conv
  then its two others' shape), each first conv twice (one a direction) and
  the others' shape four times; the fusion's once."""
  return sum(r[key] * (1 if i >= 14 else 2 if i % 2 == 0 else 4)
             for i, r in enumerate(results))


def pieces_trace(failures):
  """One eager 1080p bf16 midpoint under the profiler: the device kernels
  launched inside `Conv.conv_leaky` at the flow estimators' and the
  decoder's 3x3 convs (each call marked by a profiler range). All 50 must
  be `conv3x3_pieces_wgmma_kernel`, and no cuDNN conv kernel
  (`sm90_xmma_fprop*`) may run inside one."""
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  rng = np.random.RandomState(1)
  x0, x1 = (torch.from_numpy(rng.rand(1, 1088, 1920, 3).astype(
      np.float32)).cuda() for _ in range(2))
  t = torch.full((1, 1), 0.5, device='cuda')
  real = layers.Conv.conv_leaky

  def marked(self, x, weights=None):
    if self.weight.shape[-1] != 3:
      return real(self, x, weights)
    with torch.profiler.record_function('smoke.conv_leaky'):
      return real(self, x, weights)

  layers.Conv.conv_leaky = marked
  try:
    with torch.no_grad():
      model(x0, x1, t)
      torch.cuda.synchronize()
      activities = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
      with torch.profiler.profile(activities=activities) as prof:
        model(x0, x1, t)
        torch.cuda.synchronize()
  finally:
    layers.Conv.conv_leaky = real
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
  ranges = collections.defaultdict(list)
  launches = {}
  for e in events:
    if e['name'] == 'smoke.conv_leaky' and (
        e.get('cat') != 'gpu_user_annotation'):
      ranges[e['tid']].append((e['ts'], e['ts'] + e['dur']))
    elif e.get('cat') in ('cuda_runtime', 'cuda_driver'):
      corr = e.get('args', {}).get('correlation')
      if corr is not None:
        launches[corr] = (e['ts'], e['tid'])
  inside = collections.Counter()
  fprop_total = 0
  for e in events:
    if e.get('cat') != 'kernel':
      continue
    name = e['name']
    fprop = 'xmma_fprop' in name
    fprop_total += fprop
    launch = launches.get(e.get('args', {}).get('correlation'))
    if launch is None:
      continue
    ts, tid = launch
    if any(a <= ts <= b for a, b in ranges.get(tid, ())):
      inside['pieces' if 'conv3x3_pieces_wgmma_kernel' in name else
             'fprop' if fprop else 'other'] += 1
  report = {'marked_calls': sum(len(v) for v in ranges.values()),
            'pieces_kernels': inside['pieces'],
            'fprop_kernels_inside': inside['fprop'],
            'other_kernels_inside': inside['other'],
            'fprop_kernels_elsewhere': fprop_total - inside['fprop']}
  if (report['marked_calls'] != PAIR_LAUNCHES['conv3x3_pieces'] or
      report['pieces_kernels'] != PAIR_LAUNCHES['conv3x3_pieces'] or
      report['fprop_kernels_inside'] or report['other_kernels_inside']):
    failures.append(f'pieces trace {report}')
  print(f'pieces trace, 1080p bf16 midpoint (eager): {report}')
  return report


def training_flow(kind: str, b: int, h: int, w: int) -> torch.Tensor:
  """The flows the backward kernels are checked with.

  seam: the smooth-seam flow; large: the same plus a displacement of about
  a third of the frame; oob: uniform in +-1.5 frames, so most taps clamp;
  integer: the seam flow rounded, so every raw offset is exactly 0 (and
  the last row and column exactly 1): the clip gradient's 0.5 ties.
  """
  flow = smooth_seam_flow(h, w).expand(b, h, w, 2)
  if kind == 'large':
    flow = flow + torch.tensor([0.37 * w, -0.29 * h], device='cuda')
  elif kind == 'oob':
    rng = np.random.RandomState(h + w)
    flow = torch.from_numpy(((rng.rand(b, h, w, 2) - 0.5) * 3.0 *
                             max(h, w)).astype(np.float32)).cuda()
  elif kind == 'integer':
    flow = torch.round(flow)
  return flow.contiguous()


def check_planes(rng, b, h, w, c, dtype, bound, flow_kind, timed):
  image = torch.from_numpy(rng.rand(b, h, w, c).astype(np.float32)).to(
      'cuda', dtype)
  flow = training_flow(flow_kind, b, h, w)
  got = warp.warp_planes_kernel(image, flow)
  want = warp.warp_planes_plain(image, flow)
  torch.cuda.synchronize()
  err = max((g.float() - p.float()).abs().max().item()
            for g, p in zip(got, want))
  result = {'shape': f'{b}x{h}x{w}x{c}', 'flow': flow_kind,
            'dtype': str(dtype).split('.')[-1], 'max_abs_err': err,
            'bound': bound, 'ok': err <= bound}
  if timed:
    # No single PyTorch call computes the planes.
    add_timing(result, lambda: warp.warp_planes_kernel(image, flow),
               lambda: warp.warp_planes_plain(image, flow), None,
               14.0 * image.numel(),
               3 * image.numel() * image.element_size() + flow.numel() * 4,
               measure.PEAK_FLOPS['float32'])
  return result


def check_splat(rng, b, h, w, c, dtype, bound, flow_kind, timed):
  """The splat against its plain version within `bound`, and two launches
  on one input bit-equal: its sums run in a fixed order (C13) in the
  default mode, where the train step runs it."""
  g = torch.from_numpy((rng.rand(b, h, w, c) - 0.5).astype(np.float32)).to(
      'cuda', dtype)
  flow = training_flow(flow_kind, b, h, w)
  got = warp.splat_kernel(g, flow)
  again = warp.splat_kernel(g, flow)
  want = warp.splat_plain(g, flow)
  torch.cuda.synchronize()
  repeat_equal = torch.equal(got, again)
  err = (got - want).abs().max().item()
  rel = err / want.abs().max().item()
  result = {'shape': f'{b}x{h}x{w}x{c}', 'flow': flow_kind,
            'dtype': str(dtype).split('.')[-1], 'max_abs_err': err,
            'rel_err': rel, 'bound': bound, 'repeat_bit_equal': repeat_equal,
            'ok': rel <= bound and repeat_equal}
  if timed:
    # The library call: the image gradient of grid_sample's backward
    # (bilinear, border, align_corners=True) under the warp's grid, made
    # beforehand. In f32, as the splat's accumulator is, so a bf16 g is
    # widened beforehand; the call also computes the grid's gradient, which
    # reads the image. The bound counts the splat's bytes: g read, the f32
    # accumulator written once.
    grid = measure.bilinear_grid(flow)
    g_nchw = g.float().permute(0, 3, 1, 2)
    image_nchw = torch.zeros_like(g_nchw)

    def library():
      return torch.ops.aten.grid_sampler_2d_backward(
          g_nchw, image_nchw, grid, 0, 1, True, [True, False])[0]

    result['library_rel_err'] = ((library().permute(0, 2, 3, 1) - want).abs(
        ).max() / want.abs().max()).item()
    add_timing(result, lambda: warp.splat_kernel(g, flow),
               lambda: warp.splat_plain(g, flow), library, 8.0 * g.numel(),
               g.numel() * (g.element_size() + 4) + flow.numel() * 4,
               measure.PEAK_FLOPS['float32'])
  return result


def check_splat_order(rng, b, h, w, c, dtype, flow_kind):
  """The splat's fixed-order route against its ordered reference
  (warp.splat_fixed_order_plain: each element summed from 0 in the order
  of the source pixel's flat index, then the corner, one rounding a
  product and one an add): bit-equal, so the order is the documented one
  and not only the same on each run."""
  g = torch.from_numpy((rng.rand(b, h, w, c) - 0.5).astype(np.float32)).to(
      'cuda', dtype)
  flow = training_flow(flow_kind, b, h, w)
  with deterministic():
    got = warp.splat_kernel(g, flow)
  want = warp.splat_fixed_order_plain(g, flow)
  torch.cuda.synchronize()
  equal = torch.equal(got, want)
  return {'shape': f'{b}x{h}x{w}x{c}', 'flow': flow_kind,
          'dtype': str(dtype).split('.')[-1],
          'max_abs_err': (got - want).abs().max().item(), 'bound': 0.0,
          'order_bit_equal': equal, 'ok': equal}


def _plain_warp(image, flow):
  return warp.BackwardWarp.apply(image, flow, True)


def _plain_warp_into(image, flow, out, channel):
  out[..., channel:channel + image.shape[-1]] = warp.backward_warp_plain(
      image, flow)


def _plain_conv(x, weight, bias, pool=False, negative_slope=0.2):
  out = conv_stack.Conv3x3Leaky.apply(x, weight, bias, pool, negative_slope,
                                      True)
  return out if pool else (out, None)


def _plain_pieces(pieces, weight, bias, weights=None, negative_slope=0.2):
  if weights is None:
    weights = weight.split([p.shape[-1] for p in pieces], dim=1)
  return conv3x3_pieces.conv3x3_pieces_plain(pieces, weights, bias,
                                             negative_slope)


@contextlib.contextmanager
def plain_versions():
  """Routes the model's warp and conv-stack calls to the plain versions,
  forward and backward (the same autograd Functions, plain=True), its
  warps into the fusion's input to the plain warp's copy, its decoder's
  upsampling kernel to the plain phases and its flow estimators' and
  decoder's 3x3 conv kernel to the plain sums."""
  saved = (warp.backward_warp, warp.backward_warp_into,
           conv_stack.conv3x3_leaky, upconv2x2.upconv2x2_kernel,
           conv3x3_pieces.conv3x3_pieces_kernel)
  warp.backward_warp = _plain_warp
  warp.backward_warp_into = _plain_warp_into
  conv_stack.conv3x3_leaky = _plain_conv
  upconv2x2.upconv2x2_kernel = upconv2x2.upconv2x2_plain
  conv3x3_pieces.conv3x3_pieces_kernel = _plain_pieces
  try:
    yield
  finally:
    (warp.backward_warp, warp.backward_warp_into, conv_stack.conv3x3_leaky,
     upconv2x2.upconv2x2_kernel,
     conv3x3_pieces.conv3x3_pieces_kernel) = saved


def square_frame(cy, cx, size=TRAIN_CROP, half=32):
  frame = np.zeros((size, size, 3), np.float32)
  y0, y1 = int(cy - half), int(cy + half)
  x0, x1 = int(cx - half), int(cx + half)
  frame[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 1.0
  return frame


def square_batch(rng, n=TRAIN_BATCH, size=TRAIN_CROP):
  """Moving-square triplets (tests/test_learning.py's pattern, 8x scale):
  a bright square on black, x0 and x1 its endpoints, y its midpoint."""
  x0s, x1s, ys = [], [], []
  for _ in range(n):
    cy, cx = rng.uniform(80, size - 80, size=2)
    dy, dx = rng.uniform(-24, 24, size=2)
    x0s.append(square_frame(cy - dy, cx - dx))
    ys.append(square_frame(cy, cx))
    x1s.append(square_frame(cy + dy, cx + dx))
  return {'x0': np.stack(x0s), 'x1': np.stack(x1s), 'y': np.stack(ys),
          'time': np.full((n, 1), 0.5, np.float32)}


def square_batches(seed):
  rng = np.random.RandomState(seed)
  while True:
    yield square_batch(rng)


def loss_and_grads(model, batch, losses, step):
  """The weighted loss at `step` and every parameter's gradient."""
  model.zero_grad(set_to_none=True)
  out = model(batch['x0'], batch['x1'], batch['time'])
  loss = losses_lib.compute_weighted_loss(losses, batch, out, step)
  loss.backward()
  grads = {n: None if p.grad is None else p.grad.detach().clone()
           for n, p in model.named_parameters()}
  return loss.item(), grads


def check_step_parity(label, model, batch, losses, step, failures):
  """One train step's loss and gradients, kernels vs plain, TF32 off and
  cuDNN off in both: cuDNN's f32 algorithms leave residues of either sign
  where a conv's true output is exactly 0 (the squares' black
  background), which flips leaky relu's tie at 0 between two runs whose
  inputs differ by rounding; PyTorch's own convs keep exact zeros.
  flags() allows TF32 unless told otherwise, and the conv kernel's f32
  route follows that flag: the gate holds exact f32 against exact f32."""
  with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
    _kernels.reset_launch_counts()
    loss_k, grads_k = loss_and_grads(model, batch, losses, step)
    step_launches = _kernels.launch_counts()
    with plain_versions():
      loss_p, grads_p = loss_and_grads(model, batch, losses, step)
  plain_launches = sum(_kernels.launch_counts().values()) - sum(
      step_launches.values())
  loss_rel = abs(loss_k - loss_p) / abs(loss_p)
  grad_rel, worst, bad = {}, ('', 0.0), []
  for name, gk in grads_k.items():
    gp = grads_p[name]
    if (gk is None or not torch.isfinite(gk).all() or
        not gk.abs().max().item() > 0):
      bad.append(name)
      continue
    rel = ((gk - gp).abs().max() / gp.abs().max()).item()
    grad_rel[name] = rel
    if rel > worst[1]:
      worst = (name, rel)
  if len(grads_k) != 82 or bad:
    failures.append(f'{label} step: {len(grads_k)} parameter tensors, '
                    f'without a finite non-zero gradient: {bad}')
  if not loss_rel <= LOSS_REL_BOUND:
    failures.append(f'{label} step loss rel err {loss_rel:.3e}')
  if not worst[1] <= GRAD_REL_BOUND:
    failures.append(f'{label} step grad rel err {worst[1]:.3e} '
                    f'({worst[0]})')
  if step_launches != STEP_LAUNCHES:
    failures.append(f'launches per {label} step {step_launches} != '
                    f'{STEP_LAUNCHES}')
  if plain_launches:
    failures.append(f'plain {label} step launched {plain_launches} kernels')
  n_params = sum(p.numel() for p in model.parameters())
  print(f'train step ({label}, released config {n_params} parameters, '
        f'f32, TF32 and cuDNN off, batch '
        f'{batch["x0"].shape[0]}x{TRAIN_CROP}x{TRAIN_CROP} moving squares, '
        f'step {step}, loss weights '
        f'{ {k: w(step) for k, (_, w) in losses.items()} }): loss '
        f'{loss_k:.7f} kernels, {loss_p:.7f} plain, rel err {loss_rel:.2e} '
        f'(bound {LOSS_REL_BOUND:.0e}); {len(grads_k) - len(bad)}/'
        f'{len(grads_k)} gradients finite and non-zero; worst grad rel err '
        f'{worst[1]:.3e} ({worst[0]}, bound {GRAD_REL_BOUND:.0e}); launches '
        f'per step {step_launches}')
  return {'loss_kernels': loss_k, 'loss_plain': loss_p, 'loss_rel': loss_rel,
          'grad_rel': grad_rel, 'step_launches': step_launches}


def steps_per_second(state, step_fn, batches) -> float:
  """Mean steps/s over TIMED_STEPS steps after WARMUP_STEPS, host clock."""
  for _ in range(WARMUP_STEPS):
    step_fn(state, next(batches), torch.Generator())
  torch.cuda.synchronize()
  start = time.perf_counter()
  for _ in range(TIMED_STEPS):
    step_fn(state, next(batches), torch.Generator())
  torch.cuda.synchronize()
  return TIMED_STEPS / (time.perf_counter() - start)


def train_speed(label, model, losses, step, card):
  """Steps/s with the kernels and plain, and peak memory: the trainer's
  lean step (Adam, staircase schedule) from `step`, batches made in
  memory, no augmentation; PyTorch's default precision (cuDNN convs may
  use TF32, and so does the conv kernel: its TF32 wgmma route). The
  kernels' step is the default, a captured graph; the plain one runs
  eagerly (the plain versions replace the kernels where Python launches
  them)."""
  torch.backends.cudnn.allow_tf32 = True
  opts = train_lib.TrainingOptions()
  step_fn = train_lib.make_train_step(losses, opts, with_summaries=False)
  eager_fn = train_lib.make_train_step(losses, opts, with_summaries=False,
                                       graphs=False)
  batches = (train_lib.batch_to_device(b, torch.device('cuda'))
             for b in square_batches(2))
  state = train_lib.create_train_state(model, opts)
  state.step = step
  torch.cuda.reset_peak_memory_stats()
  rate_k = steps_per_second(state, step_fn, batches)
  peak_k = torch.cuda.max_memory_allocated()
  for program in step_fn.programs():
    program.release()
  torch.cuda.reset_peak_memory_stats()
  with plain_versions():
    rate_p = steps_per_second(state, eager_fn, batches)
  peak_p = torch.cuda.max_memory_allocated()
  print(f'train speed ({label}): {rate_k:.3f} steps/s with the kernels '
        f'(captured), {rate_p:.3f} plain (eager; mean of {TIMED_STEPS} '
        f'steps after {WARMUP_STEPS}, batch {TRAIN_BATCH}x{TRAIN_CROP}x'
        f'{TRAIN_CROP}, f32, TF32 allowed); peak memory '
        f'{peak_k / 2**30:.2f} GiB kernels, {peak_p / 2**30:.2f} GiB plain; '
        f'on {card}')
  return {'steps_per_s': rate_k, 'plain_steps_per_s': rate_p,
          'peak_bytes': peak_k, 'plain_peak_bytes': peak_p}


def check_training(card, failures):
  """The film_net-L1 path: step parity, launch counts, speed, the loop,
  build_params on the loop's run."""
  config = configs.get_experiment('film_net-L1')
  options = config.model
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  batch = train_lib.batch_to_device(square_batch(np.random.RandomState(1)),
                                    torch.device('cuda'))
  l1 = losses_lib.training_losses(['l1'])
  report = check_step_parity('film_net-L1', model, batch, l1, 0, failures)
  report.update(train_speed('film_net-L1', model, l1, 0, card))
  del model

  # train_lib.train: 20 steps with the augmentations, then a resume to 25.
  with tempfile.TemporaryDirectory() as run_dir:
    runs = []
    for num_steps in (TRAIN_STEPS, RESUME_STEPS):
      lines = []
      opts = train_lib.TrainingOptions(
          num_steps=num_steps, save_interval=SAVE_INTERVAL,
          timing_interval=SAVE_INTERVAL)
      _kernels.reset_launch_counts()
      start = time.perf_counter()
      state = train_lib.train(
          create_model(options), options,
          losses_lib.training_losses(['l1']), square_batches(3), opts,
          run_dir, device='cuda',
          augmentation_names=tuple(config.augmentations),
          log_fn=lines.append)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - start
      runs.append({'steps': state.step, 'seconds': seconds, 'log': lines,
                   'launches': _kernels.launch_counts(),
                   'checkpoints': train_lib.CheckpointManager(
                       os.path.join(run_dir, 'train')).steps()})
    first, resumed = runs
    losses = [float(v) for r in runs for line in r['log']
              for v in re.findall(r'training_loss=([-+.\deE]+|nan|inf)',
                                  line)]
    state_dict, exported = params_io.load_state_bundle(
        os.path.join(run_dir, 'saved_model'))
    interpolator = Interpolator(state_dict, exported, align=64,
                                device='cuda')
    frames = square_batch(np.random.RandomState(4), n=1)
    dt = np.full((1,), 0.5, np.float32)
    mid = interpolator(frames['x0'], frames['x1'], dt)
    # build_params on the run: its newest checkpoint (step 25) as a bundle,
    # held against the trained model's own forward.
    start = time.perf_counter()
    built_dir = build_params.main([
        '--base_folder', os.path.dirname(run_dir), '--label',
        os.path.basename(run_dir), '--output',
        os.path.join(run_dir, 'built')])
    build_s = time.perf_counter() - start
    built = load_interpolator(built_dir, align=64, device='cuda')
    trained = Interpolator(state.model, options, align=64, device='cuda')
    built_err = float(np.abs(built(frames['x0'], frames['x1'], dt) -
                             trained(frames['x0'], frames['x1'], dt)).max())
    built_same = all(torch.equal(v, built.model.state_dict()[k])
                     for k, v in state.model.state_dict().items())
    del state, trained, built, interpolator
  # train_speed left TF32 allowed, as PyTorch's default has it.
  if first['launches'] != under_tf32({k: TRAIN_STEPS * v
                                      for k, v in STEP_LAUNCHES.items()}):
    failures.append(f'train launches {first["launches"]}')
  if resumed['launches'] != under_tf32(
      {k: (RESUME_STEPS - TRAIN_STEPS) * v
       for k, v in STEP_LAUNCHES.items()}):
    failures.append(f'resumed train launches {resumed["launches"]}')
  if len(losses) != 3 or not all(np.isfinite(losses)):
    failures.append(f'train losses {losses}')
  if first['checkpoints'] != [10, 20] or resumed['checkpoints'] != [
      10, 20, 25]:
    failures.append(f'checkpoints {first["checkpoints"]} then '
                    f'{resumed["checkpoints"]}')
  if f'Restored checkpoint at step {TRAIN_STEPS}' not in resumed['log']:
    failures.append('the resumed run did not restore step 20')
  if exported != options or mid.shape != (1, TRAIN_CROP, TRAIN_CROP, 3) or (
      not np.isfinite(mid).all()):
    failures.append('the exported weights did not serve a finite frame')
  if not (built_same and built_err <= REPEAT_BOUND):
    failures.append(f'build_params bundle: weights equal {built_same}, '
                    f'forward max-abs {built_err:.3e}')
  print(f'train loop: train_lib.train for {TRAIN_STEPS} steps with '
        f'{list(config.augmentations)} in {first["seconds"]:.1f} s, '
        f'checkpoints {first["checkpoints"]}; resumed to {RESUME_STEPS} in '
        f'{resumed["seconds"]:.1f} s, checkpoints {resumed["checkpoints"]}; '
        f'training_loss at steps 10/20/25 {losses}; launches '
        f'{first["launches"]} then {resumed["launches"]}; the export serves '
        f'a finite {mid.shape} frame; build_params of the run (step 25) in '
        f'{build_s:.1f} s on the host: weights equal {built_same}, forward '
        f'max-abs {built_err:.1e} from the trained model (bound '
        f'{REPEAT_BOUND:.0e})')
  report.update(train_runs=runs, train_losses=losses, build_params_err=
                built_err, build_params_s=build_s)
  return report, first['launches']


def write_vgg_mat(path: str, seed: int = 0) -> None:
  """VGG-19 to conv5_2 at its true widths, He-scaled weights from a seed,
  as a MatConvNet .mat (the released imagenet-vgg-verydeep-19.mat is not
  in the repository)."""
  rng = np.random.RandomState(seed)
  cin, kernels = 3, []
  for cout in VGG_CHANNELS:
    kernels.append(
        ((rng.randn(3, 3, cin, cout) * (2.0 / (9 * cin))**0.5).astype(
            np.float32), (rng.randn(cout) * 0.1).astype(np.float32)))
    cin = cout
  vgg19.save_vgg_weights(path, kernels)


# The TF release's layout (io/tf_bundle.py reads it): TF's table options
# (256 KiB blocks, a restart every 16 keys) and attribute-path suffix.
TF_BLOCK_SIZE, TF_RESTART_INTERVAL = 262144, 16
TF_ATTRIBUTE = '/.ATTRIBUTES/VARIABLE_VALUE'
TF_DTYPES = {np.dtype(np.float32): tf_bundle.DT_FLOAT,
             np.dtype(np.int64): tf_bundle.DT_INT64}


def proto_varint(value: int) -> bytes:
  out = bytearray()
  while True:
    byte = value & 0x7F
    value >>= 7
    if not value:
      out.append(byte)
      return bytes(out)
    out.append(byte | 0x80)


def proto_message(*fields) -> bytes:
  """A protobuf message of (field, value) pairs: an int is a varint, bytes
  or str length-delimited, ('fixed32', n) a fixed32."""
  out = bytearray()
  for field, value in fields:
    if isinstance(value, tuple):
      out += proto_varint(field << 3 | 5) + struct.pack('<I', value[1])
    elif isinstance(value, int):
      out += proto_varint(field << 3) + proto_varint(value)
    else:
      data = value.encode() if isinstance(value, str) else value
      out += proto_varint(field << 3 | 2) + proto_varint(len(data)) + data
  return bytes(out)


def tf_table(entries) -> bytes:
  """A LevelDB-style table of sorted (key, value) bytes pairs as TF's
  table builder writes it: prefix-compressed data blocks with restarts,
  each with a trailer (type 0, masked CRC32C), an index block of each
  data block's last key, an empty metaindex block and the footer."""
  out, index = bytearray(), []

  def finish(block: bytearray, restarts) -> tuple:
    block += b''.join(struct.pack('<I', r) for r in restarts)
    block += struct.pack('<I', len(restarts))
    handle = (len(out), len(block))
    out.extend(block)
    out.extend(b'\0' + struct.pack(
        '<I', tfrecord.masked_crc32c(bytes(block) + b'\0')))
    return handle

  def build(pairs) -> tuple:
    block, restarts, last = bytearray(), [], b''
    for i, (key, value) in enumerate(pairs):
      shared = 0
      if i % TF_RESTART_INTERVAL == 0:
        restarts.append(len(block))
      else:
        while (shared < min(len(key), len(last)) and
               key[shared] == last[shared]):
          shared += 1
      block += (proto_varint(shared) + proto_varint(len(key) - shared) +
                proto_varint(len(value)) + key[shared:] + value)
      last = key
    return finish(block, restarts or [0])

  pending = []
  for key, value in entries:
    pending.append((key, value))
    if sum(len(k) + len(v) for k, v in pending) >= TF_BLOCK_SIZE:
      index.append((pending[-1][0], build(pending)))
      pending = []
  if pending:
    index.append((pending[-1][0], build(pending)))
  metaindex = build([])
  index_handle = build([(key, proto_varint(offset) + proto_varint(size))
                        for key, (offset, size) in index])
  handles = b''.join(proto_varint(v) for v in metaindex + index_handle)
  out += handles.ljust(40, b'\0') + struct.pack('<Q', tf_bundle.MAGIC)
  return bytes(out)


def tf_string_scalar(data: bytes) -> tuple:
  """A string scalar's bundle bytes and their entry CRC."""
  size = struct.pack('<I', len(data))
  checksum = struct.pack('<I', tfrecord.masked_crc32c(size))
  return (proto_varint(len(data)) + checksum + data,
          tfrecord.masked_crc32c(size + checksum + data))


def tf_object_graph(entries) -> bytes:
  """A TrackableObjectGraph whose nodes are the checkpoint keys' path
  components (children by local name) and whose attributes name each
  entry's variable."""
  children, attributes = [[]], [[]]
  for key, full_name, _ in entries:
    node = 0
    for part in key[:-len(TF_ATTRIBUTE)].split('/'):
      found = [child for name, child in children[node] if name == part]
      if not found:
        children.append([])
        attributes.append([])
        children[node].append((part, len(children) - 1))
        found = [len(children) - 1]
      node = found[0]
    attributes[node].append(proto_message(
        (1, 'VARIABLE_VALUE'), (2, full_name), (3, key)))
  nodes = [proto_message(
      *[(1, proto_message((1, child), (2, name))) for name, child in kids],
      *[(2, attribute) for attribute in attrs])
           for kids, attrs in zip(children, attributes)]
  return proto_message(*[(1, node) for node in nodes])


def tf_release_entries(state, options: Options, prefix: str):
  """(checkpoint key, variable name, HWIO/bias array) of every weight, as
  the reference's Keras model saves them: attribute paths by tracked
  layer (feat_net 0, predict_flow 1, fusion 2), and its names, the
  fusion's Keras auto-names in creation order."""
  tree = params_io.to_flax_params(state)
  entries = []
  for k in range(2 * options.sub_levels):
    entries.append((f'layer_with_weights-0/extract_sublevels/convs/{k}',
                    f'feat_net/sub_extractor/cfeat_conv_{k}',
                    tree['feat_net']['sub_extractor'][f'cfeat_conv_{k}']))
  for i in range(options.specialized_levels + 1):
    name = (f'flow_predictor_{i}' if i < options.specialized_levels else
            'flow_predictor_shared')
    for j in range(options.flow_convs[i] + 2):
      entries.append((f'layer_with_weights-1/_predictors/{i}/_convs/{j}',
                      f'predict_flow/{name}/conv_{j}',
                      tree['predict_flow'][name][f'conv_{j}']))
  levels = options.fusion_pyramid_levels
  scopes = [f'convs/{i}/{s}' for i in range(levels - 1) for s in range(3)]
  modules = [f'conv_{i}_{s}' for i in range(levels - 1) for s in range(3)]
  for n, (scope, module) in enumerate(zip(scopes + ['output_conv'],
                                          modules + ['output_conv'])):
    entries.append((f'layer_with_weights-2/{scope}',
                    'fusion/conv2d' + (f'_{n}' if n else ''),
                    tree['fusion'][module]))
  return [(f'{prefix}{path}/{leaf}{TF_ATTRIBUTE}', f'{name}/{leaf}',
           np.ascontiguousarray(conv[leaf], np.float32))
          for path, name, conv in entries for leaf in ('kernel', 'bias')]


def write_tf_bundle(prefix: str, entries) -> None:
  """`<prefix>.index` and `<prefix>.data-00000-of-00001` holding the
  (key, variable name, array) entries and their object graph."""
  graph, graph_crc = tf_string_scalar(tf_object_graph(entries))
  tensors = {tf_bundle.OBJECT_GRAPH_KEY: (tf_bundle.DT_STRING, (), graph,
                                           graph_crc)}
  for key, _, array in entries:
    data = array.tobytes()
    tensors[key] = (TF_DTYPES[array.dtype], array.shape, data,
                    tfrecord.masked_crc32c(data))
  table = [(b'', proto_message((1, 1), (3, proto_message((1, 1)))))]
  offset = 0
  with open(tf_bundle.data_path(prefix, 0, 1), 'wb') as f:
    for key in sorted(tensors):
      dtype, shape, data, crc = tensors[key]
      f.write(data)
      shape_proto = proto_message(
          *[(2, proto_message((1, size))) for size in shape])
      table.append((key.encode(), proto_message(
          (1, dtype), (2, shape_proto), (4, offset), (5, len(data)),
          (6, ('fixed32', crc)))))
      offset += len(data)
  with open(prefix + '.index', 'wb') as f:
    f.write(tf_table(sorted(table)))


def write_tf_checkpoint(path: str, state, options: Options,
                        form: str = 'checkpoint') -> None:
  """The weights `state` as a TF release of the reference lays them out
  (the released files are not in the repository), in one of two forms:

    * 'checkpoint': tf.train.Checkpoint(model=...).save's directory:
      `checkpoint`, `ckpt-1.index`, `ckpt-1.data-00000-of-00001`, keys
      under `model/`, with `save_counter` and an Adam slot of the first
      kernel, which an import must skip;
    * 'saved_model': `variables/variables.{index,data-00000-of-00001}`,
      keys from the model's root, and a `saved_model.pb` placeholder that
      nothing parses (the weights' import never reads it).
  """
  os.makedirs(path, exist_ok=True)
  if form == 'saved_model':
    os.makedirs(os.path.join(path, 'variables'), exist_ok=True)
    write_tf_bundle(os.path.join(path, 'variables', 'variables'),
                    tf_release_entries(state, options, ''))
    with open(os.path.join(path, 'saved_model.pb'), 'wb'):
      pass
    return
  entries = tf_release_entries(state, options, 'model/')
  kernel_key, kernel_name, kernel = entries[0]
  slot = kernel_key.replace(TF_ATTRIBUTE,
                            '/.OPTIMIZER_SLOT/optimizer/m' + TF_ATTRIBUTE)
  entries += [(slot, f'Adam/{kernel_name}/m', np.zeros_like(kernel)),
              ('save_counter' + TF_ATTRIBUTE, 'save_counter',
               np.array(1, np.int64))]
  write_tf_bundle(os.path.join(path, 'ckpt-1'), entries)
  with open(os.path.join(path, 'checkpoint'), 'w') as f:
    f.write('model_checkpoint_path: "ckpt-1"\n'
            'all_model_checkpoint_paths: "ckpt-1"\n')


def loss_ms(loss_fn, batch, image) -> float:
  """One loss's forward and its backward to the image, by CUDA events."""
  def run():
    pred = image.detach().requires_grad_()
    loss_fn(batch, {'image': pred}).backward()
  return measure.time_ms(run, iters=5, queued=False)


def check_style(mat_path, card, l1_report, failures):
  """One film_net-Style train step (released config, f32, VGG-19 at its
  true widths): parity, launches, speed, and the losses' share."""
  config = configs.get_experiment('film_net-Style', mat_path)
  options = config.model
  start = time.perf_counter()
  vgg19.load_vgg_weights(mat_path)
  load_s = time.perf_counter() - start
  style = losses_lib.training_losses(
      list(config.training_losses.names),
      loss_weight_schedules=list(config.training_losses.weight_schedules),
      vgg_model_file=config.vgg_model_file)
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  batch = train_lib.batch_to_device(square_batch(np.random.RandomState(1)),
                                    torch.device('cuda'))
  report = check_step_parity('film_net-Style', model, batch, style,
                             STYLE_STEP, failures)
  report.update(train_speed('film_net-Style', model, style, STYLE_STEP,
                            card))

  # The share of the VGG and Style losses in a step (TF32 allowed, as the
  # speed above): each loss's forward and backward to the prediction, vgg
  # and style together as the step runs them (one tower an image,
  # vgg19.shared_features), and the lean step with all three losses and
  # with l1 alone, CUDA events.
  opts = train_lib.TrainingOptions()
  state = train_lib.create_train_state(model, opts)
  state.step = STYLE_STEP
  with torch.no_grad():
    image = model(batch['x0'], batch['x1'], batch['time'])['image']
  parts = {name: loss_ms(fn, batch, image)
           for name, (fn, _) in style.items()}
  towers = {k: style[k] for k in ('k*vgg', 'k*style')}
  parts['vgg+style'] = loss_ms(
      lambda example, prediction: losses_lib.compute_weighted_loss(
          towers, example, prediction, STYLE_STEP), batch, image)
  # The towers of one eager Style step: the prediction's with grad, the
  # reference's without.
  calls = []
  counted = vgg19.vgg_features

  def count(image, model_filepath):
    calls.append('grad' if torch.is_grad_enabled() else 'no_grad')
    return counted(image, model_filepath)

  vgg19.vgg_features = count
  try:
    train_lib.make_train_step(style, opts, with_summaries=False,
                              graphs=False)(state, batch, torch.Generator())
  finally:
    vgg19.vgg_features = counted
  if sorted(calls) != ['grad', 'no_grad']:
    failures.append(f'film_net-Style step ran VGG-19 towers {calls}, not '
                    f'one with grad and one without')
  steps = {}
  for label, losses in (('l1', losses_lib.training_losses(['l1'])),
                        ('style', style)):
    step_fn = train_lib.make_train_step(losses, opts, with_summaries=False)
    steps[label] = measure.time_ms(
        lambda: step_fn(state, batch, torch.Generator()), iters=5,
        queued=False)
  share = parts['vgg+style'] / steps['style']
  print(f'film_net-Style step parts (CUDA events, TF32 allowed, batch '
        f'{TRAIN_BATCH}): {steps["style"]:.3f} ms a step '
        f'({1e3 / steps["style"]:.3f} steps/s), {steps["l1"]:.3f} with l1 '
        f'alone; forward + image backward of l1 {parts["l1"]:.3f} ms, vgg '
        f'{parts["k*vgg"]:.3f} alone, style {parts["k*style"]:.3f} alone, '
        f'vgg and style sharing their towers {parts["vgg+style"]:.3f}: '
        f'{100 * share:.1f}% of the step; towers a step {calls}; VGG-19 '
        f'.mat read in {load_s:.2f} s; L1 speed in this call '
        f'{l1_report["steps_per_s"]:.3f} steps/s; on {card}')
  report.update(step_ms=steps, loss_ms=parts, loss_share=share,
                vgg_load_s=load_s, towers=calls,
                style_steps_per_s=1e3 / steps['style'])
  return report


def adam_kernels_by_step(events, kernels):
  """Adam's update on the device in each traced step: the foreach kernels
  (multi_tensor_apply) launched under the step's host annotation, matched
  to their launch by its correlation id. A replayed graph's kernels carry
  the correlation of its cudaGraphLaunch, so a captured step counts as an
  eager one does."""
  spans = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                 if e.get('name') == 'fi.train.step' and
                 e.get('cat') == 'user_annotation')
  step_of = {}
  for e in events:
    correlation = e.get('args', {}).get('correlation')
    if e.get('cat') in ('cuda_runtime', 'cuda_driver') and (
        correlation is not None):
      for i, (begin, end) in enumerate(spans):
        if begin <= e['ts'] <= end:
          step_of[correlation] = i
  counts = [0] * len(spans)
  for k in kernels:
    i = step_of.get(k.get('args', {}).get('correlation'))
    if i is not None and 'multi_tensor_apply' in k['name']:
      counts[i] += 1
  return counts


def check_gin_loop(mat_path, card, failures):
  """train_lib.train of an inline film_net-Style gin, loaded by the port's
  gin_compat, for GIN_STEPS steps with the trace window."""
  with tempfile.TemporaryDirectory() as work:
    gin_path = os.path.join(work, 'film_net-Style.gin')
    with open(gin_path, 'w') as f:
      f.write(STYLE_GIN.replace('{mat}', mat_path))
    config = gin_compat.load_training_gin(gin_path)
    if config.vgg_model_file != mat_path or config.training_losses.names != (
        'l1', 'vgg', 'style'):
      failures.append(f'gin config {config.training_losses.names} '
                      f'{config.vgg_model_file}')
    losses = losses_lib.training_losses(
        list(config.training_losses.names),
        loss_weight_schedules=list(config.training_losses.weight_schedules),
        vgg_model_file=config.vgg_model_file)
    opts = train_lib.TrainingOptions(
        learning_rate=config.learning_rate, num_steps=GIN_STEPS,
        save_interval=GIN_STEPS, timing_interval=GIN_STEPS)
    profile_dir, lines = os.path.join(work, 'profile'), []
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    state = train_lib.train(
        create_model(config.model), config.model, losses, square_batches(6),
        opts, os.path.join(work, 'run'), device='cuda',
        augmentation_names=tuple(config.augmentations), log_fn=lines.append,
        profile_dir=profile_dir, profile_start_step=PROFILE_START,
        profile_num_steps=PROFILE_STEPS)
    seconds = time.perf_counter() - start
    launches = _kernels.launch_counts()
    end = PROFILE_START + PROFILE_STEPS
    trace_path = os.path.join(profile_dir,
                              f'steps_{PROFILE_START}_{end}.json')
    with open(trace_path) as f:
      events = json.load(f)['traceEvents']
    trace_mb = os.path.getsize(trace_path) / 2**20
    del state
  kernels = [e for e in events if e.get('cat') == 'kernel']
  # The host's annotation of each step (the device's copy of it has the
  # category gpu_user_annotation): the trainer's own, since a replayed
  # step never calls Adam.step from Python; Adam's annotation counts the
  # eager updates.
  def annotations(name):
    return sum(1 for e in events
               if e.get('name') == name and e.get('cat') == 'user_annotation')

  traced_steps = annotations('fi.train.step')
  adam_steps = annotations('Optimizer.step#Adam.step')
  adam_kernels = adam_kernels_by_step(events, kernels)
  ours = {}
  for pattern in TRACE_KERNELS:
    hits = [e for e in kernels if pattern in e['name']]
    ours[pattern] = {'launches': len(hits),
                     'ms': sum(e.get('dur', 0.0) for e in hits) / 1e3}
  busy_ms = sum(e.get('dur', 0.0) for e in kernels) / 1e3
  logged = (f'Wrote profiler trace for steps [{PROFILE_START}, {end}) to '
            f'{trace_path}')
  if launches != under_tf32({k: GIN_STEPS * v
                             for k, v in STEP_LAUNCHES.items()}):
    failures.append(f'gin loop launches {launches}')
  if logged not in lines or traced_steps != PROFILE_STEPS or not all(
      v['launches'] for v in ours.values()) or len(adam_kernels) != (
          PROFILE_STEPS) or len(set(adam_kernels)) != 1 or not adam_kernels[0]:
    failures.append(f'trace window: logged {logged in lines}, '
                    f'{traced_steps} steps, Adam\'s kernels by step '
                    f'{adam_kernels}, our kernels {ours}')
  print(f'gin loop (film_net-Style from an inline gin through gin_compat, '
        f'{GIN_STEPS} steps of batch {TRAIN_BATCH} with '
        f'{list(config.augmentations)}) in {seconds:.1f} s; launches '
        f'{launches}; trace of steps [{PROFILE_START}, {end}): '
        f'{trace_mb:.1f} MB, {traced_steps} steps ({adam_steps} eager Adam '
        f'updates; Adam\'s foreach kernels by step {adam_kernels}), '
        f'{len(kernels)} kernels '
        f'busy {busy_ms:.3f} ms ({busy_ms / PROFILE_STEPS:.3f} ms a step, '
        f'under the profiler), ours {ours}; on {card}')
  return {'launches': launches, 'seconds': seconds, 'trace_mb': trace_mb,
          'traced_steps': traced_steps, 'adam_steps': adam_steps,
          'adam_kernels_by_step': adam_kernels,
          'kernel_busy_ms': busy_ms,
          'trace_kernels': ours}


def check_jax_bundle(model, options, want, frames, dt, card, failures):
  """The serving model written as the JAX package's bundle (options.json +
  params.msgpack), read back through load_interpolator, serving the same
  pair as the Interpolator built from the model itself."""
  with tempfile.TemporaryDirectory() as bundle:
    start = time.perf_counter()
    params_io.save_params(bundle, model.state_dict(), options)
    write_s = time.perf_counter() - start
    size = os.path.getsize(os.path.join(bundle, params_io.PARAMS_FILE))
    start = time.perf_counter()
    state, loaded_options = params_io.load_params(bundle)
    decode_s = time.perf_counter() - start
    interpolator = load_interpolator(bundle, align=64, device='cuda')
  same = loaded_options == options and all(
      torch.equal(state[k], v.cpu()) for k, v in model.state_dict().items())
  _kernels.reset_launch_counts()
  got = interpolator(frames[0], frames[1], dt)
  launches = _kernels.launch_counts()
  err = float(np.abs(got - want).max())
  if not same:
    failures.append('the JAX bundle does not hold the serving weights')
  if launches != PAIR_LAUNCHES:
    failures.append(f'JAX bundle pair launches {launches}')
  if got.shape != want.shape or err > REPEAT_BOUND:
    failures.append(f'JAX bundle pair {got.shape}, max-abs {err:.3e}')
  print(f'JAX bundle (released config, {size / 1e6:.1f} MB params.msgpack): '
        f'written in {write_s:.2f} s, decoded in {decode_s:.2f} s on the '
        f'host (io/msgpack_lite); options and weights equal: {same}; a 1080p '
        f'pair served from it (bf16 policy) max-abs {err:.1e} from the '
        f'direct Interpolator (bound {REPEAT_BOUND:.0e}); launches '
        f'{launches}; on {card}')
  return {'bytes': size, 'write_s': write_s, 'decode_s': decode_s,
          'max_abs_err': err, 'launches': launches}


def check_tf_release(model, options, want, frames, dt, card, bundle_report,
                     failures):
  """The serving model written as a TF release of the reference (both
  forms of write_tf_checkpoint), read back without TensorFlow
  (io/tf_import), served through load_interpolator, converted by
  cli.build_params --tf_model, and gated by cli.verify_released."""
  state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
  jax_mb_s = bundle_report['bytes'] / 1e6 / bundle_report['decode_s']
  native.available()  # the first CRC of the run builds it: before the timings
  report = {}
  with tempfile.TemporaryDirectory() as work:
    for form in ('checkpoint', 'saved_model'):
      path = os.path.join(work, form)
      start = time.perf_counter()
      write_tf_checkpoint(path, state, options, form)
      write_s = time.perf_counter() - start
      size = sum(os.path.getsize(os.path.join(root, name))
                 for root, _, names in os.walk(path) for name in names)
      start = time.perf_counter()
      loaded, loaded_options = tf_import.load_tf_params(path)
      read_s = time.perf_counter() - start
      same = loaded.keys() == state.keys() and all(
          torch.equal(loaded[k], v) for k, v in state.items())
      interpolator = load_interpolator(path, align=64,
                                       dtype_policy=options.dtype_policy,
                                       device='cuda')
      _kernels.reset_launch_counts()
      got = interpolator(frames[0], frames[1], dt)
      launches = _kernels.launch_counts()
      err = float(np.abs(got - want).max())
      bundle = os.path.join(work, f'{form}_bundle')
      build_params.main(['--tf_model', path, '--output', bundle])
      built, built_options = params_io.load_state_bundle(bundle)
      built_same = built_options == loaded_options and all(
          torch.equal(built[k], v) for k, v in state.items())
      if not (same and loaded_options == dataclasses.replace(
          options, dtype_policy='float32')):
        failures.append(f'TF {form}: the import does not hold the serving '
                        'weights')
      if launches != PAIR_LAUNCHES:
        failures.append(f'TF {form} pair launches {launches}')
      if got.shape != want.shape or err > REPEAT_BOUND:
        failures.append(f'TF {form} pair {got.shape}, max-abs {err:.3e}')
      if not built_same:
        failures.append(f'TF {form}: build_params --tf_model differs')
      mb_s = size / 1e6 / read_s
      note = ('; its saved_model.pb is a placeholder that nothing parses'
              if form == 'saved_model' else '')
      print(f'TF release, {form} form (released config, {size / 1e6:.1f} MB'
            f'{note}): written in {write_s:.2f} s, read by io/tf_import in '
            f'{read_s:.2f} s on the host ({mb_s:.1f} MB/s; the JAX bundle '
            f'decoded at {jax_mb_s:.1f} MB/s in this run); state_dict '
            f'bit-equal: {same}; a 1080p pair served from it (bf16 policy) '
            f'max-abs {err:.1e} from the direct Interpolator (bound '
            f'{REPEAT_BOUND:.0e}); launches {launches}; build_params '
            f'--tf_model equal: {built_same}; on {card}')
      report[form] = {'bytes': size, 'write_s': write_s, 'read_s': read_s,
                      'mb_s': mb_s, 'max_abs_err': err,
                      'launches': launches, 'build_params_equal': built_same}

    # The release gate on the checkpoint form: the import and the smoke on
    # two seeded frames run on the card; the TF checks skip (no
    # SavedModel here, and this host has no TensorFlow).
    argv = ['--model_path', os.path.join(work, 'checkpoint'),
            '--device', 'cuda']
    try:
      rng = np.random.RandomState(9)
      pair = [rng.rand(1080, 1920, 3).astype(np.float32) for _ in range(2)]
      for i, frame in enumerate(pair):
        images.write_image(os.path.join(work, f'frame{i}.png'), frame)
      record = os.path.join(work, 'gate.tfrecord')
      with tfrecord.TFRecordWriter(record) as writer:
        writer.write(records.make_triplet_example(
            [pair[0], pair[0], pair[1]], path='gate'))
      argv += ['--frame1', os.path.join(work, 'frame0.png'),
               '--frame2', os.path.join(work, 'frame1.png'),
               '--tfrecord', record]
    except ImportError as e:
      print(f'verify_released: frames not written: PIL does not import on '
            f'this host ({e}); the gate runs its import check alone')
    out = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
      status = verify_released.main(argv)
    gate_s = time.perf_counter() - start
    line = out.getvalue().strip().splitlines()[-1]
    result = json.loads(line)
  skipped = {name: check['skipped']
             for name, check in result['checks'].items()
             if 'skipped' in check}
  if status != 0 or not result['pass']:
    failures.append(f'verify_released: {line}')
  print(f'verify_released on the checkpoint form in {gate_s:.1f} s: exit '
        f'{status}, pass {result["pass"]}, {result["checks_run"]} checks run, '
        f'skipped {skipped}; on {card}')
  print(line)
  report['verify_released'] = {'status': status, 'result': result,
                               'seconds': gate_s}
  return report


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
  mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64))**2))
  return 10.0 * np.log10(1.0 / max(mse, 1e-20))


def min_frame_psnr(a: np.ndarray, b: np.ndarray) -> float:
  return min(psnr_db(x, y) for x, y in zip(a, b))


def check_uint8_rules(failures):
  """The exact uint8 rules on the card."""
  values = torch.arange(256, dtype=torch.int32).to(torch.uint8).cuda()
  got = interpolator_lib.u8_to_unit_f32(values).cpu().numpy()
  want = np.arange(256, dtype=np.float32) / np.float32(255)
  wrong = int((got.view(np.uint32) != want.view(np.uint32)).sum())
  # What the rule avoids: true division by 255 on the card.
  naive = (values.float() / 255).cpu().numpy()
  naive_wrong = int((naive.view(np.uint32) != want.view(np.uint32)).sum())
  rng = np.random.RandomState(7)
  frame = (rng.rand(1080, 1920, 3) * 1.4 - 0.2).astype(np.float32)
  frame[0, :256, 0] = (np.arange(256) + 0.5) / np.float32(255)
  frame[1, :6, 0] = [0.0, 1.0, -1.0, 2.0, -0.0, 0.5]
  quantized = cached_tree.quantize_u8(torch.from_numpy(frame).cuda())
  q_wrong = int((quantized.cpu().numpy() != images.to_uint8(frame)).sum())
  if wrong:
    failures.append(f'u8 -> f32: {wrong} of 256 byte values differ')
  if q_wrong:
    failures.append(f'device quantization: {q_wrong} bytes differ')
  print(f'uint8 rules: u8 -> f32 of all 256 byte values {256 - wrong}/256 '
        f'bit-equal to numpy v / 255 (true division on the card: '
        f'{naive_wrong} differ); device quantization of a 1080x1920x3 '
        f'frame in [-0.2, 1.2) with .5 boundaries: {q_wrong} bytes differ '
        f'from io.images.to_uint8')
  return {'u8_wrong': wrong, 'naive_div_wrong': naive_wrong,
          'quantize_wrong': q_wrong}


def release_memory() -> None:
  """Returns what dropped objects held (captured graphs' pools among them)
  to the device before the next phase."""
  gc.collect()
  torch.cuda.empty_cache()


def run_counted(fn):
  """fn() with the launch counts set to 0 before it; its result, the
  counts just after, and the peak device memory it took."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _kernels.reset_launch_counts()
  out = fn()
  torch.cuda.synchronize()
  return out, _kernels.launch_counts(), torch.cuda.max_memory_allocated()


def live_captures(interpolator):
  return {name: list(p.captures.values())
          for name, p in interpolator.programs.items()}


def new_captures(interpolator, before):
  """The captures made since `before` (live_captures), by program: the
  bytes each grew the pool by."""
  made = {name: [c.pool_bytes for c in p.captures.values()
                 if not any(c is old for old in before[name])]
          for name, p in interpolator.programs.items()}
  return {name: sizes for name, sizes in made.items() if sizes}


def chunked_tree(interpolator, frames):
  """The chunked tree of `frames` at VIDEO_TIMES in batches of
  VIDEO_MAX_BATCH through `interpolator`'s pair program: the route of
  parallel/inference.ShardedVideoInterpolator, on one device."""
  with torch.inference_mode():
    return interpolator_lib.expand_tree_chunked(
        interpolator.to_device(frames), VIDEO_TIMES, VIDEO_MAX_BATCH, False,
        interpolator.interpolate_device)


def check_video(interpolator, eager, card, failures):
  """The frame tree of 3 1080p frames at T = 3, by both routes (through
  `interpolator`'s programs; `eager`, the same model without graphs,
  runs the plain versions). A route's later calls replay what its first
  call captured."""
  frames = np.random.RandomState(0).randint(
      0, 256, (VIDEO_FRAMES, VIDEO_H, VIDEO_W, 3)).astype(np.uint8)
  frames_dev = torch.from_numpy(frames).cuda()
  report, routes = {}, {
      'cached': lambda: interpolator.expand_tree_device(frames_dev,
                                                        VIDEO_TIMES),
      'cached_uint8': lambda: interpolator.expand_tree_device(
          frames_dev, VIDEO_TIMES, as_uint8=True),
      'chunked': lambda: chunked_tree(interpolator, frames_dev),
  }
  outputs = {}
  pool = interpolator.programs['pair'].pool
  for name, route in routes.items():
    before, clears = live_captures(interpolator), pool.clears
    out, launches, peak = run_counted(route)
    captured = new_captures(interpolator, before)
    first_clears = pool.clears - clears
    outputs[name] = out.cpu().numpy()
    want = CHUNKED_TREE_LAUNCHES if name == 'chunked' else (
        CACHED_TREE_LAUNCHES)
    if launches != want:
      failures.append(f'{name} tree launches {launches} != {want}')
    # End to end on the card: the host's lag between launches counts.
    before, clears = live_captures(interpolator), pool.clears
    ms = measure.time_ms(route, iters=2, queued=False)
    recaptured = new_captures(interpolator, before)
    if recaptured or pool.clears != clears:
      failures.append(f'{name} tree: later calls captured {recaptured}, '
                      f'{pool.clears - clears} clears')
    report[name] = {'launches': launches, 'peak_bytes': peak,
                    'ms': ms, 'ms_per_frame': ms / VIDEO_OUTPUTS,
                    'captured_bytes': captured, 'clears': first_clears,
                    'recaptured_bytes': recaptured,
                    'pool_bytes': pool.bytes}
  cached, chunked = outputs['cached'], outputs['chunked']
  if cached.shape != (VIDEO_OUTPUTS, VIDEO_H, VIDEO_W, 3) or not np.isfinite(
      cached).all():
    failures.append(f'cached tree output {cached.shape}, or not finite')
  if not np.array_equal(cached[::2**VIDEO_TIMES],
                        frames.astype(np.float32) / np.float32(255)):
    failures.append('the cached tree does not carry the input frames')
  chunked_psnr = min_frame_psnr(chunked, cached)
  if not chunked_psnr >= TREE_PSNR_DB:
    failures.append(f'chunked vs cached tree {chunked_psnr:.2f} dB')
  levels = int(np.abs(outputs['cached_uint8'].astype(np.int32) -
                      images.to_uint8(cached).astype(np.int32)).max())
  if levels > UINT8_LEVELS:
    failures.append(f'uint8 tree vs host quantization: {levels} levels')

  with plain_versions():
    plain, plain_launches, _ = run_counted(
        lambda: eager.expand_tree_device(frames_dev, VIDEO_TIMES))
  plain_psnr = min_frame_psnr(cached, plain.cpu().numpy())
  if sum(plain_launches.values()):
    failures.append(f'plain tree launched {plain_launches}')
  if not plain_psnr >= PSNR_BOUND_DB:
    failures.append(f'tree kernels vs plain {plain_psnr:.2f} dB')

  # The streaming driver (one pair a chunk, two chunks in flight, fetched
  # on a side stream) against the whole tree's one fetch; host frames.
  inputs = list(frames)
  start = time.perf_counter()
  streamed = list(recursion.interpolate_frontier_streaming(
      inputs, VIDEO_TIMES, interpolator, pairs_per_chunk=1,
      pipeline_depth=2))
  stream_ms = 1e3 * (time.perf_counter() - start)
  whole = recursion.interpolate_frontier(inputs, VIDEO_TIMES, interpolator)
  stream_err = max(float(np.abs(a - b).max())
                   for a, b in zip(streamed, whole))
  if (len(streamed), len(whole)) != (VIDEO_OUTPUTS, VIDEO_OUTPUTS) or (
      stream_err > REPEAT_BOUND):
    failures.append(f'streaming vs frontier: {len(streamed)} frames, '
                    f'max-abs {stream_err:.3e}')
  start = time.perf_counter()
  written = list(recursion.interpolate_frontier_streaming(
      inputs, VIDEO_TIMES, interpolator, pairs_per_chunk=1,
      pipeline_depth=2, as_uint8=True))
  stream_u8_ms = 1e3 * (time.perf_counter() - start)
  if not np.array_equal(np.stack(written), outputs['cached_uint8']):
    failures.append('streaming uint8 frames differ from the uint8 tree')
  gib = lambda sizes: [round(n / 2**30, 2) for n in sizes]
  for name in routes:
    r = report[name]
    print(f'video tree {name} (3 1080p uint8 frames, T = {VIDEO_TIMES}, '
          f'{VIDEO_OUTPUTS} frames, bf16 policy): '
          f'{r["ms_per_frame"]:.3f} ms per output frame on the device '
          f'({r["ms"]:.3f} ms a tree), peak memory '
          f'{r["peak_bytes"] / 2**30:.2f} GiB, launches {r["launches"]}; '
          f'the first call captured '
          f'{ {k: gib(v) for k, v in r["captured_bytes"].items()} } GiB '
          f'with {r["clears"]} clears, the next three '
          f'{ {k: gib(v) for k, v in r["recaptured_bytes"].items()} }; pool '
          f'{r["pool_bytes"] / 2**30:.2f} GiB')
  print(f'video tree checks: chunked vs cached min frame PSNR '
        f'{chunked_psnr:.2f} dB (bound {TREE_PSNR_DB}); uint8 vs host '
        f'quantization {levels} levels (bound {UINT8_LEVELS}); kernels vs '
        f'plain over the cached tree {plain_psnr:.2f} dB (bound '
        f'{PSNR_BOUND_DB}); streaming (1 pair a chunk, depth 2) vs frontier '
        f'max-abs {stream_err:.1e} (bound {REPEAT_BOUND:.0e}), '
        f'{stream_ms / VIDEO_OUTPUTS:.3f} ms per frame on the host clock, '
        f'{stream_u8_ms / VIDEO_OUTPUTS:.3f} as uint8; on {card}')
  pool_bytes = sum(p.pool_bytes for p in interpolator.programs.values())
  clears = interpolator.programs['pair'].pool.clears
  print(f'video tree graphs: {len(interpolator.programs)} programs, '
        f'{sum(len(p.captures) for p in interpolator.programs.values())} '
        f'live graphs, which grew their pool by {pool_bytes / 2**30:.2f} GiB,'
        f' the pool emptied {clears} times by its budget, '
        f'{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; on {card}')
  report.update(chunked_psnr=chunked_psnr, uint8_levels=levels,
                plain_psnr=plain_psnr, stream_err=stream_err, pool_bytes=
                pool_bytes, pool_clears=clears,
                stream_ms_per_frame=stream_ms / VIDEO_OUTPUTS,
                stream_uint8_ms_per_frame=stream_u8_ms / VIDEO_OUTPUTS)
  return report


def check_tiled_tree(model, options, card, failures):
  """The tiled tree of a 1080p pair (2x2 patches, T = 1) against the
  tiled pair forward."""
  tiled = Interpolator(model, options, align=64, block_shape=(2, 2),
                       device='cuda')
  frames = np.random.RandomState(1).rand(2, VIDEO_H, VIDEO_W, 3).astype(
      np.float32)
  frames_dev = torch.from_numpy(frames).cuda()
  tree, launches, peak = run_counted(
      lambda: tiled.expand_tree_device(frames_dev, 1))
  tree = tree.cpu().numpy()
  ms = measure.time_ms(lambda: tiled.expand_tree_device(frames_dev, 1),
                       iters=2, queued=False)
  pair = tiled(frames[:1], frames[1:], np.full((1,), 0.5, np.float32))[0]
  psnr = psnr_db(tree[1], pair)
  if launches != TILED_TREE_LAUNCHES:
    failures.append(f'tiled tree launches {launches} != '
                    f'{TILED_TREE_LAUNCHES}')
  if tree.shape != (3, VIDEO_H, VIDEO_W, 3) or not psnr >= TREE_PSNR_DB:
    failures.append(f'tiled tree {tree.shape}, {psnr:.2f} dB vs the pair')
  print(f'tiled tree (a 1080p pair, 2x2 patches, T = 1): {psnr:.2f} dB vs '
        f'the tiled pair forward (bound {TREE_PSNR_DB}); {ms:.3f} ms a '
        f'tree, peak memory {peak / 2**30:.2f} GiB; launches {launches}; '
        f'on {card}')
  return {'psnr': psnr, 'launches': launches, 'ms': ms, 'peak_bytes': peak}


def check_spatial(model, options, frames, dt, want, card, failures):
  """The row-sharded 1080p pair on [cuda:0] * n, n = 4 and 2, and over
  every GPU where there are more, against the single-device output."""
  x0, x1 = (torch.from_numpy(f).cuda() for f in frames)
  dtd = torch.from_numpy(dt).cuda()
  meshes = [(n, parallel_mesh.Mesh(['cuda:0'] * n)) for n in (SHARDS, 2)]
  if torch.cuda.device_count() > 1:
    meshes.append((None, parallel_mesh.create_mesh()))
  report = {}
  for n, mesh in meshes:
    interp = sharded.SpatialShardedInterpolator(model, options, mesh,
                                                align=64)
    out, launches, peak = run_counted(lambda: interp.call_device(x0, x1, dtd))
    out = out.cpu().numpy()
    ms = measure.time_ms(lambda: interp.call_device(x0, x1, dtd), iters=3,
                         queued=False)
    psnr = psnr_db(out, want)
    name = repr(mesh)
    if out.shape != want.shape or not np.isfinite(out).all() or not (
        psnr >= SPATIAL_PSNR_DB):
      failures.append(f'spatial {name}: {out.shape}, {psnr:.2f} dB')
    if n is not None and launches != SPATIAL_LAUNCHES[n]:
      failures.append(f'spatial {name} launches {launches} != '
                      f'{SPATIAL_LAUNCHES[n]}')
    print(f'spatial sharding {name} (1080p pair, released config, bf16 '
          f'policy): {psnr:.2f} dB vs one device (bound {SPATIAL_PSNR_DB}); '
          f'{ms:.3f} ms a pair on the device, peak memory '
          f'{peak / 2**30:.2f} GiB; launches {launches}; on {card}')
    report[name] = {'psnr': psnr, 'ms': ms, 'peak_bytes': peak,
                    'launches': launches}
    del interp
  return report


def check_sharded_patches_and_tree(model, options, interpolator, card,
                                   failures):
  """The 2x2 patches of a 1080p pair over 4 shards against the tiled pair,
  and the 17-frame tree over 4 shards against the chunked tree of
  `interpolator`."""
  mesh = parallel_mesh.Mesh(['cuda:0'] * SHARDS)
  frames = np.random.RandomState(1).rand(2, 1, VIDEO_H, VIDEO_W, 3).astype(
      np.float32)
  x0, x1 = (torch.from_numpy(f).cuda() for f in frames)
  dtd = torch.full((1,), 0.5, device='cuda')
  tiled = Interpolator(model, options, align=64, block_shape=(2, 2),
                       device='cuda')
  want = tiled.call_device(x0, x1, dtd).cpu().numpy()
  patches = sharded.ShardedInterpolator(model, options, mesh, (2, 2),
                                        align=64)
  out, launches, peak = run_counted(lambda: patches.call_device(x0, x1, dtd))
  patch_psnr = psnr_db(out.cpu().numpy(), want)
  patch_ms = measure.time_ms(lambda: patches.call_device(x0, x1, dtd),
                             iters=3, queued=False)
  if not patch_psnr >= SPATIAL_PSNR_DB:
    failures.append(f'sharded patches {patch_psnr:.2f} dB vs tiled')
  if launches != SHARDED_PATCH_LAUNCHES:
    failures.append(f'sharded patch launches {launches} != '
                    f'{SHARDED_PATCH_LAUNCHES}')
  report = {'patches': {'psnr': patch_psnr, 'ms': patch_ms,
                        'peak_bytes': peak, 'launches': launches}}
  print(f'sharded patches {mesh!r} (1080p pair, 2x2 patches): '
        f'{patch_psnr:.2f} dB vs the tiled pair (bound {SPATIAL_PSNR_DB}); '
        f'{patch_ms:.3f} ms a pair, peak memory {peak / 2**30:.2f} GiB; '
        f'launches {launches}; on {card}')
  del patches, tiled

  video = torch.from_numpy(np.random.RandomState(0).randint(
      0, 256, (VIDEO_FRAMES, VIDEO_H, VIDEO_W, 3)).astype(np.uint8)).cuda()
  chunked = chunked_tree(interpolator, video).cpu().numpy()
  tree_interp = sharded.ShardedVideoInterpolator(model, options, mesh,
                                                 align=64)
  out, launches, peak = run_counted(
      lambda: tree_interp.expand_tree_device(video, VIDEO_TIMES))
  out = out.cpu().numpy()
  tree_psnr = min_frame_psnr(out, chunked)
  tree_ms = measure.time_ms(
      lambda: tree_interp.expand_tree_device(video, VIDEO_TIMES), iters=2,
      queued=False)
  if out.shape != chunked.shape or not tree_psnr >= SPATIAL_PSNR_DB:
    failures.append(f'sharded tree {out.shape}, {tree_psnr:.2f} dB vs the '
                    f'chunked tree')
  if launches != SHARDED_TREE_LAUNCHES:
    failures.append(f'sharded tree launches {launches} != '
                    f'{SHARDED_TREE_LAUNCHES}')
  report['tree'] = {'psnr': tree_psnr, 'ms': tree_ms,
                    'ms_per_frame': tree_ms / VIDEO_OUTPUTS,
                    'peak_bytes': peak, 'launches': launches}
  print(f'sharded tree {mesh!r} ({VIDEO_OUTPUTS} frames of 1080p, one node '
        f'a shard): {tree_psnr:.2f} dB min frame vs the chunked tree (bound '
        f'{SPATIAL_PSNR_DB}); {tree_ms / VIDEO_OUTPUTS:.3f} ms per output '
        f'frame, peak memory {peak / 2**30:.2f} GiB; launches {launches}; '
        f'on {card}')
  return report


def check_eval(card, failures):
  """eval_lib.eval_loop, kernels vs plain in exact f32, and its program
  (the forward and the metrics captured a batch shape) against its eager
  path; ms per example of both in turns over EVAL_TIMED_BATCHES batches,
  the program's warm-up and capture included."""
  config = configs.get_experiment('film_net-L1')
  options = config.model
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  metrics = metrics_lib.create_metrics_fns(
      losses_lib.test_losses(['l1', 'l2', 'ssim', 'psnr']),
      losses_lib.training_losses(['l1']))
  rng = np.random.RandomState(5)
  datasets = {'vimeo_like': []}
  for _ in range(EVAL_BATCHES):
    frames = rng.rand(3, 1, EVAL_H, EVAL_W, 3).astype(np.float32)
    datasets['vimeo_like'].append({
        'x0': frames[0], 'y': frames[1], 'x1': frames[2],
        'time': np.full((1, 1), 0.5, np.float32)})

  def run(graphs=None, data=datasets):
    return eval_lib.eval_loop(model, data, metrics, 0, log_fn=lambda _: None,
                              graphs=graphs)['vimeo_like']

  timed = {'vimeo_like': datasets['vimeo_like'] * (
      EVAL_TIMED_BATCHES // EVAL_BATCHES)}
  def turns():
    ms = {'graphs': [], 'eager': []}
    for label in ('graphs', 'eager', 'eager', 'graphs'):
      ms[label].append(measure.time_ms(
          lambda: run(label == 'graphs', timed), iters=1, queued=False) /
                       EVAL_TIMED_BATCHES)
    return ms

  with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
    got, launches, _ = run_counted(run)
    eager, eager_launches, _ = run_counted(lambda: run(False))
    exact_turns = turns()
    with plain_versions():
      want, plain_launches, _ = run_counted(lambda: run(False))
  # As a user's eval runs: cuDNN on, TF32 allowed (PyTorch's default).
  with tf32_allowed(True):
    ms_turns = turns()
  ms = mean(ms_turns['graphs'])
  graph_errors = {name: abs(got[name] - value) / max(abs(value), 1e-12)
                  for name, value in eager.items()}
  if max(graph_errors.values()) > EVAL_REL_BOUND or (
      eager_launches != launches):
    failures.append(f'eval program vs eager: {graph_errors}, launches '
                    f'{launches} vs {eager_launches}')
  errors = {}
  for name, value in want.items():
    diff = abs(got[name] - value)
    if name == 'psnr':
      errors[name], ok = diff, diff <= EVAL_PSNR_BOUND_DB
    elif name == 'ssim':
      errors[name], ok = diff, diff <= EVAL_SSIM_BOUND
    else:
      errors[name] = diff / abs(value)
      ok = errors[name] <= EVAL_REL_BOUND
    if not ok:
      failures.append(f'eval {name}: {got[name]} kernels, {value} plain')
  want_launches = exact_f32({k: EVAL_BATCHES * v
                             for k, v in PAIR_LAUNCHES.items()})
  if launches != want_launches:
    failures.append(f'eval launches {launches} != {want_launches}')
  if sum(plain_launches.values()):
    failures.append(f'plain eval launched {plain_launches}')
  print(f'eval loop (released config, f32, TF32 and cuDNN off, '
        f'{EVAL_BATCHES} batches of one {EVAL_H}x{EVAL_W} triplet): '
        f'kernels {got}, plain {want}; errors {errors} (bounds: '
        f'{EVAL_REL_BOUND:.0e} relative, SSIM {EVAL_SSIM_BOUND:.0e}, PSNR '
        f'{EVAL_PSNR_BOUND_DB:.0e} dB); the program vs its eager path: '
        f'{graph_errors} (bound {EVAL_REL_BOUND:.0e} relative); ms per '
        f'example over {EVAL_TIMED_BATCHES} batches, a program\'s warm-up '
        f'and capture included: TF32 allowed, cuDNN on {ms:.3f} with '
        f'graphs, {mean(ms_turns["eager"]):.3f} eager (turns g/e/e/g: '
        f'{ms_turns}); exact f32, cuDNN off '
        f'{mean(exact_turns["graphs"]):.3f} with graphs, '
        f'{mean(exact_turns["eager"]):.3f} eager ({exact_turns}); launches '
        f'{launches}; on {card}')
  return {'kernels': got, 'plain': want, 'eager': eager, 'errors': errors,
          'graph_errors': graph_errors, 'launches': launches,
          'ms_per_example': ms, 'ms_turns': ms_turns,
          'exact_ms_turns': exact_turns}


# ---- PR 8: split convs, the native CRC, the builders, data-parallel -------


def form_interpolators(state, dtype_policy: str):
  """The released config under `dtype_policy` in both split forms, from
  the same weights."""
  out = {}
  for form in ('off', 'on'):
    options = Options.film_net_released(dtype_policy=dtype_policy,
                                        split_convs=form)
    model = create_model(options)
    model.load_state_dict(state)
    out[form] = Interpolator(model, options, align=64, device='cuda')
  return out


def check_split(state, frames, dt, card, failures):
  """The split-concat convs against the concat form: the 1080p bf16 pair
  (agreement, launches, ms a pair in turns), the pair in f32 at 544x960,
  one film_net-L1 step in each form, and the row-sharded pair on
  [cuda:0] * 2 with split convs against one device."""
  x0, x1 = (torch.from_numpy(f).cuda() for f in frames)
  dtd = torch.from_numpy(dt).cuda()
  interps = form_interpolators(state, 'bfloat16')
  outs, report = {}, {'launches': {}, 'ms': {'off': [], 'on': []}}
  for form, interp in interps.items():
    out, launches, _ = run_counted(lambda: interp.call_device(x0, x1, dtd))
    outs[form] = out.float().cpu().numpy()
    report['launches'][form] = launches
    if launches != PAIR_LAUNCHES:
      failures.append(f'split_convs={form} pair launches {launches}')
  psnr = psnr_db(outs['on'], outs['off'])
  if not psnr >= SPLIT_PSNR_DB:
    failures.append(f'split vs concat pair {psnr:.2f} dB')
  for form in ('off', 'on', 'on', 'off'):
    report['ms'][form].append(measure.time_ms(
        lambda: interps[form].call_device(x0, x1, dtd), iters=3,
        queued=False))
  auto = 'on' if layers.should_split('auto') else 'off'
  means = {f: float(np.mean(v)) for f, v in report['ms'].items()}
  print(f'split convs, 1080p pair (released config, bf16 policy): split vs '
        f'concat {psnr:.2f} dB (bound {SPLIT_PSNR_DB}); ms a pair (CUDA '
        f'events, in turns off/on/on/off, 3 pairs each) concat '
        f'{report["ms"]["off"]} mean {means["off"]:.3f}, split '
        f'{report["ms"]["on"]} mean {means["on"]:.3f}; launches '
        f'{report["launches"]}; split_convs=\'auto\' on cuda picks '
        f'{auto!r}; on {card}')
  del interps

  small = np.random.RandomState(6).rand(2, 1, SPLIT_H, SPLIT_W, 3).astype(
      np.float32)
  f32_interps = form_interpolators(state, 'float32')
  f32 = {form: interp(small[0], small[1], dt)
         for form, interp in f32_interps.items()}
  f32_err = float(np.abs(f32['on'] - f32['off']).max())
  if not f32_err <= SPLIT_F32_BOUND:
    failures.append(f'split vs concat f32 max-abs {f32_err:.3e}')
  # The f32 pair under PyTorch's default TF32 switch, as the CLI serves a
  # release: all 62 conv sites take the TF32 route (none did above, TF32
  # off, nor in the bf16 pairs).
  # Its output against the plain versions' (eager; their convs on cuDNN
  # in TF32 too): the 3x3 pieces kernel takes each of its tile plans on
  # this pair's levels.
  options = Options.film_net_released(dtype_policy='float32',
                                      split_convs='on')
  model = create_model(options)
  model.load_state_dict(state)
  eager = Interpolator(model, options, align=64, device='cuda', graphs=False)
  with tf32_allowed(True):
    tf32_out, tf32_launches, _ = run_counted(
        lambda: f32_interps['on'](small[0], small[1], dt))
    with plain_versions():
      tf32_plain, tf32_plain_launches, _ = run_counted(
          lambda: eager(small[0], small[1], dt))
  if tf32_launches != under_tf32(PAIR_LAUNCHES):
    failures.append(f'f32 pair under TF32 launches {tf32_launches}')
  tf32_psnr = psnr_db(tf32_out, tf32_plain)
  if sum(tf32_plain_launches.values()) or not tf32_psnr >= TF32_PAIR_PSNR_DB:
    failures.append(f'f32 pair under TF32 vs plain {tf32_psnr:.2f} dB, '
                    f'plain launches {tf32_plain_launches}')
  del f32_interps, eager, model

  # One film_net-L1 step in each form, TF32 and cuDNN off (as the step
  # parity runs), held to the step-parity bounds.
  config = configs.get_experiment('film_net-L1')
  train_state = init_params(create_model(config.model),
                            torch.Generator().manual_seed(0)).state_dict()
  batch = train_lib.batch_to_device(square_batch(np.random.RandomState(1)),
                                    torch.device('cuda'))
  l1 = losses_lib.training_losses(['l1'])
  steps = {}
  with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
    for form in ('off', 'on'):
      model = create_model(dataclasses.replace(config.model,
                                               split_convs=form))
      model.load_state_dict(train_state)
      model.cuda()
      (loss, grads), launches, _ = run_counted(
          lambda: loss_and_grads(model, batch, l1, 0))
      steps[form] = (loss, grads, launches)
      del model
  loss_rel = abs(steps['on'][0] - steps['off'][0]) / abs(steps['off'][0])
  worst, bad = ('', 0.0), []
  for name, g in steps['on'][1].items():
    ref = steps['off'][1][name]
    if g is None or not torch.isfinite(g).all() or not g.abs().max() > 0:
      bad.append(name)
      continue
    rel = ((g - ref).abs().max() / ref.abs().max()).item()
    worst = max(worst, (name, rel), key=lambda w: w[1])
  if len(steps['on'][1]) != 82 or bad:
    failures.append(f'split step: gradients without a finite non-zero '
                    f'value {bad}')
  if not loss_rel <= LOSS_REL_BOUND or not worst[1] <= GRAD_REL_BOUND:
    failures.append(f'split vs concat step: loss rel {loss_rel:.3e}, '
                    f'grad rel {worst[1]:.3e} ({worst[0]})')
  for form, (_, _, launches) in steps.items():
    if launches != STEP_LAUNCHES:
      failures.append(f'split_convs={form} step launches {launches}')
  print(f'split convs, f32: the 544x960 pair split vs concat max-abs '
        f'{f32_err:.2e} (bound {SPLIT_F32_BOUND:.0e}); under TF32 its '
        f'launches {tf32_launches}, against the plain versions '
        f'{tf32_psnr:.2f} dB (bound {TF32_PAIR_PSNR_DB}); one film_net-L1 '
        f'step '
        f'(batch 8x256x256, TF32 and cuDNN off): loss {steps["on"][0]:.7f} '
        f'split, {steps["off"][0]:.7f} concat, rel {loss_rel:.2e} (bound '
        f'{LOSS_REL_BOUND:.0e}); worst grad rel {worst[1]:.3e} ({worst[0]}, '
        f'bound {GRAD_REL_BOUND:.0e}); {82 - len(bad)}/82 finite and '
        f'non-zero; launches a step {steps["on"][2]}; on {card}')

  # The row-sharded pair with split convs: each split conv's two pieces
  # take their halos in one exchange.
  options = Options.film_net_released(dtype_policy='bfloat16',
                                      split_convs='on')
  model = create_model(options)
  model.load_state_dict(state)
  mesh = parallel_mesh.Mesh(['cuda:0'] * 2)
  interp = sharded.SpatialShardedInterpolator(model, options, mesh, align=64)
  out, launches, _ = run_counted(lambda: interp.call_device(x0, x1, dtd))
  rows_psnr = psnr_db(out.float().cpu().numpy(), outs['on'])
  if not rows_psnr >= SPATIAL_PSNR_DB or launches != SPATIAL_LAUNCHES[2]:
    failures.append(f'row-sharded split pair {rows_psnr:.2f} dB, launches '
                    f'{launches}')
  print(f'split convs, row-sharded 1080p pair on {mesh!r}: '
        f'{rows_psnr:.2f} dB vs one device (bound {SPATIAL_PSNR_DB}); '
        f'launches {launches}; on {card}')
  report.update(psnr=psnr, auto=auto, f32_err=f32_err, loss_rel=loss_rel,
                grad_rel=worst[1], step_launches=steps['on'][2],
                rows_psnr=rows_psnr, f32_tf32_launches=tf32_launches)
  return report


def mask_crc(crc: int) -> int:
  """The TFRecord mask of a CRC, in Python."""
  return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


@contextlib.contextmanager
def python_crc():
  """data/tfrecord.py as on a host where the native library does not
  build: the Python loop."""
  saved = native.available
  native.available = lambda: False
  try:
    yield
  finally:
    native.available = saved


def check_native_crc(card, failures):
  """The native CRC built with cc on this host, against the Python loop on
  64 MiB of seeded bytes and on a TFRecord of them the port's writer
  wrote; MB/s of both."""
  native.library()  # raises if cc is absent or the build fails
  # The first CRC the run took (the TF release phase) built it.
  build_s = native.BUILD_INFO['seconds']
  data = np.random.RandomState(7).bytes(CRC_BYTES)
  mb = CRC_BYTES / 2**20
  start = time.perf_counter()
  for _ in range(CRC_REPEATS):
    got = native.crc32c(data)
  native_mbs = CRC_REPEATS * mb / (time.perf_counter() - start)
  start = time.perf_counter()
  want = tfrecord.python_crc32c(data)
  python_mbs = mb / (time.perf_counter() - start)
  masked_ok = native.masked_crc32c(data) == mask_crc(want)
  payloads = [data[i:i + CRC_RECORD] for i in range(0, CRC_BYTES, CRC_RECORD)]
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'crc.tfrecord')
    backend = tfrecord.crc_backend()
    with tfrecord.TFRecordWriter(path) as writer:
      for p in payloads:
        writer.write(p)
    with open(path, 'rb') as f:
      frames = native.scan_tfrecord(f.read())
    start = time.perf_counter()
    native_read = list(tfrecord.read_records(path, validate=True))
    read_mbs = mb / (time.perf_counter() - start)
    start = time.perf_counter()
    with python_crc():
      python_read = list(tfrecord.read_records(path, validate=True))
    python_read_mbs = mb / (time.perf_counter() - start)
  scan_ok = (len(frames) == len(payloads) and native_read == payloads ==
             python_read)
  ok = got == want and masked_ok and scan_ok and backend == 'native'
  if not ok:
    failures.append(f'native CRC: crc {got:#x} vs python {want:#x}, masked '
                    f'{masked_ok}, scan {scan_ok}, writer backend {backend}')
  built = (f'built on this host with cc in {build_s:.2f} s' if build_s
           else 'found built')
  print(f'native CRC: {built} ({native.BUILD_INFO["path"]}); crc32c of {mb:.0f} MiB of seeded bytes '
        f'{got:#010x} native, {want:#010x} Python, masked equal {masked_ok}; '
        f'{native_mbs:.1f} MB/s native, {python_mbs:.2f} MB/s Python; a '
        f'TFRecord of {len(payloads)} 1 MiB records written with the '
        f'{backend} CRC: scan and read_records(validate=True) equal the '
        f'Python reader {scan_ok}, reading {read_mbs:.1f} MB/s native, '
        f'{python_read_mbs:.2f} MB/s Python; on {card}')
  return {'ok': ok, 'build_s': build_s, 'native_mb_s': native_mbs,
          'python_mb_s': python_mbs, 'read_mb_s': read_mbs,
          'python_read_mb_s': python_read_mbs}


def builder_frame(rng, h=VIDEO_H, w=VIDEO_W):
  """A seeded uint8 frame: a smooth gradient with a bright square."""
  yy, xx = np.mgrid[0:h, 0:w]
  frame = np.stack([(xx * 255 // w), (yy * 255 // h),
                    np.full((h, w), rng.randint(256))], axis=-1)
  cy, cx = rng.randint(100, h - 300), rng.randint(100, w - 300)
  frame[cy:cy + 200, cx:cx + 200] = rng.randint(256, size=3)
  return frame.astype(np.uint8)


def check_builders(card, failures):
  """cli.create_middlebury_tfrecord on a seeded 1080p Middlebury-layout
  tree (4 clips, 2 shards), read back and evaluated on the card against
  the same frames from memory. Needs PIL, which this host may lack."""
  try:
    from PIL import Image
  except ImportError as e:
    print(f'builders: not run: PIL does not import on this host ({e}); '
          'the CPU tests carry the builders')
    return {'ran': False}
  rng = np.random.RandomState(8)
  names = ('frame10.png', 'frame10i11.png', 'frame11.png')
  clips = {f'clip{i}': [builder_frame(rng) for _ in names]
           for i in range(BUILDER_CLIPS)}
  config = configs.get_experiment('film_net-L1')
  model = init_params(create_model(config.model),
                      torch.Generator().manual_seed(0)).cuda()
  metrics = metrics_lib.create_metrics_fns(
      losses_lib.test_losses(['l1', 'l2', 'ssim', 'psnr']),
      losses_lib.training_losses(['l1']))
  with tempfile.TemporaryDirectory() as root:
    for clip, frames in clips.items():
      for name, frame in zip(names, frames):
        folder = 'other-gt-interp' if name == 'frame10i11.png' else (
            'other-data')
        os.makedirs(os.path.join(root, folder, clip), exist_ok=True)
        Image.fromarray(frame).save(os.path.join(root, folder, clip, name))
    out = os.path.join(root, 'records', 'middlebury.tfrecord')
    start = time.perf_counter()
    written = create_middlebury_tfrecord.main([
        '--input_dir', root, '--output_tfrecord_filepath', out,
        '--num_shards', str(BUILDER_SHARDS)])
    build_s = time.perf_counter() - start
    records = dataset_lib.create_eval_datasets(
        [f'{out}@{BUILDER_SHARDS}'], ['middlebury'], batch_size=1)
    # Round-robin over the shards, read in shard order.
    order = [f'clip{i}' for s in range(BUILDER_SHARDS)
             for i in range(s, BUILDER_CLIPS, BUILDER_SHARDS)]
    memory = [{'x0': clips[c][0][None] / np.float32(255),
               'y': clips[c][1][None] / np.float32(255),
               'x1': clips[c][2][None] / np.float32(255),
               'time': np.full((1, 1), 0.5, np.float32)} for c in order]
    results = {}
    for name, ds in (('records', records['middlebury']), ('memory', memory)):
      got, launches, _ = run_counted(lambda: eval_lib.eval_loop(
          model, {'middlebury': ds}, metrics, 0, log_fn=lambda _: None))
      results[name] = (got['middlebury'], launches)
  del model
  # The f32 model's eval after the training phases: TF32 allowed.
  want_launches = under_tf32({k: BUILDER_CLIPS * v
                              for k, v in PAIR_LAUNCHES.items()})
  errors = {}
  for name, value in results['memory'][0].items():
    diff = abs(results['records'][0][name] - value)
    errors[name] = diff if name == 'ssim' else diff / max(abs(value), 1e-12)
  ok = (written == BUILDER_CLIPS and max(errors.values()) <= BUILDER_BOUND
        and results['records'][1] == want_launches)
  if not ok:
    failures.append(f'builders: {written} written, errors {errors}, '
                    f'launches {results["records"][1]}')
  print(f'builders: create_middlebury_tfrecord wrote {written} 1080p '
        f'triplets into {BUILDER_SHARDS} shards in {build_s:.1f} s (native '
        f'CRC); eval_loop on the card (released config, f32) from the '
        f'records {results["records"][0]}, from memory '
        f'{results["memory"][0]}; errors {errors} (bound '
        f'{BUILDER_BOUND:.0e}); launches {results["records"][1]}; on {card}')
  return {'ran': True, 'written': written, 'build_s': build_s,
          'errors': errors}


def ddp_steps(device, data_parallel: bool, steps: int = DDP_STEPS,
              timed: bool = True, graphs=False, grads_at: int = 0):
  """film_net-L1 train steps (released config, f32) on the global batches
  of moving squares, with the augmentations: `steps` under TF32 and cuDNN
  off (losses, launches a step, step `grads_at`'s gradients, which a
  data-parallel step leaves averaged), then, if `timed`, steps/s with
  PyTorch's default precision. `graphs` is make_train_step's: eager by
  default; a captured step's first call is its warm-up, the next ones
  replays."""
  config = configs.get_experiment('film_net-L1')
  model = init_params(create_model(config.model),
                      torch.Generator().manual_seed(0)).to(device)
  opts = train_lib.TrainingOptions()
  step_fn = train_lib.make_train_step(
      losses_lib.training_losses(['l1']), opts, tuple(config.augmentations),
      with_summaries=False, data_parallel=data_parallel, graphs=graphs)
  state = train_lib.create_train_state(model, opts)
  batches = square_batches(5)
  result = {'losses': [], 'launches': []}

  def step():
    batch = train_lib.batch_to_device(next(batches), device)
    return step_fn(state, batch, train_lib.step_generator(0, state.step))[0]

  with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
    for i in range(steps):
      metrics, launches, _ = run_counted(step)
      result['losses'].append(float(metrics['training_loss']))
      result['launches'].append(launches)
      if i == grads_at:
        result['grads'] = {n: p.grad.detach().cpu().clone()
                           for n, p in model.named_parameters()}
  if timed:
    with tf32_allowed(True):
      for _ in range(DDP_WARMUP):
        step()
      torch.cuda.synchronize()
      start = time.perf_counter()
      for _ in range(DDP_TIMED):
        step()
      torch.cuda.synchronize()
      result['steps_per_s'] = DDP_TIMED / (time.perf_counter() - start)
  return result


def ddp_rank_main(args) -> int:
  """One rank of the data-parallel phase (a subprocess of this script)."""
  torch.backends.cudnn.allow_tf32 = False
  backend = distributed.initialize_multihost(args.ddp_url, args.ddp_world,
                                             args.ddp_rank, 'cuda')
  try:
    device = distributed.rank_device('cuda')
    torch.cuda.set_device(device)
    if args.ddp_world == 1:
      result = ddp_world1(device)
    else:
      result = ddp_steps(device, data_parallel=True)
    result.update(backend=backend, device=str(device))
    if args.ddp_rank != 0:
      del result['grads']
    torch.save(result, os.path.join(args.ddp_out, f'rank{args.ddp_rank}.pt'))
  finally:
    distributed.shutdown()
  return 0


def ddp_world1(device):
  """World size 1 over NCCL: the data-parallel step captured (its
  all-reduce inside the graph) against the step of one process without
  the group, also captured, both under torch.use_deterministic_algorithms
  (cuDNN's deterministic algorithms), from the same seed: two steps each, the
  first the warm-up, the second a replay, so the replays' loss and
  gradients must match bit for bit; the NCCL all-reduce of the replay's
  gradients must return their bits. Then steps/s of the data-parallel
  step with and without graphs in turns (TF32 allowed)."""
  with deterministic():
    result = ddp_steps(device, data_parallel=True, steps=2, timed=False,
                       graphs=None, grads_at=1)
    alone = ddp_steps(device, data_parallel=False, steps=2, timed=False,
                      graphs=None, grads_at=1)
  grads = [g.to(device) for g in alone['grads'].values()]
  reduced = distributed.all_reduce_mean(grads)
  result['alone'] = {
      'losses': alone['losses'],
      'all_reduce_identity': all(torch.equal(a, b)
                                 for a, b in zip(grads, reduced)),
      'grads': alone['grads'], 'launches': alone['launches']}
  rates = {'graphs': [], 'eager': []}
  for turn in ('graphs', 'eager', 'eager', 'graphs'):
    rates[turn].append(ddp_steps(
        device, data_parallel=True, steps=0,
        graphs=None if turn == 'graphs' else False)['steps_per_s'])
  result['steps_per_s'] = rates
  return result


def run_ranks(world: int, out_dir: str):
  """Runs `world` ranks of ddp_rank_main as subprocesses; their results."""
  url = f'file://{out_dir}/rendezvous_{world}'
  procs = [subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), '--ddp_rank', str(r),
       '--ddp_world', str(world), '--ddp_url', url, '--ddp_out', out_dir],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
           for r in range(world)]
  try:
    logs = [p.communicate(timeout=DDP_TIMEOUT_S)[0] for p in procs]
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
  for r, (p, log) in enumerate(zip(procs, logs)):
    if p.returncode != 0:
      raise CheckFailed(f'data-parallel rank {r} of {world} exited with '
                        f'{p.returncode}:\n{log[-4000:]}')
  return [torch.load(os.path.join(out_dir, f'rank{r}.pt'), weights_only=True)
          for r in range(world)]


def compare_ranks(label, ranks, single, backend, failures):
  """The ranks' steps against one process's on the global batch."""
  first = ranks[0]
  loss_rel = abs(first['losses'][0] - single['losses'][0]) / abs(
      single['losses'][0])
  trajectory = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r['losses'], single['losses']))
  worst = max(((n, ((g - single['grads'][n]).abs().max() /
                    single['grads'][n].abs().max()).item())
               for n, g in first['grads'].items()), key=lambda w: w[1])
  launches_ok = all(l == STEP_LAUNCHES for r in ranks for l in r['launches'])
  backends = {r['backend'] for r in ranks}
  if not (loss_rel <= LOSS_REL_BOUND and worst[1] <= GRAD_REL_BOUND and
          trajectory <= DDP_TRAJECTORY_BOUND and launches_ok and
          backends == {backend} and len(first['grads']) == 82):
    failures.append(f'{label}: backends {backends}, loss rel {loss_rel:.2e}, '
                    f'grad rel {worst[1]:.2e} ({worst[0]}), trajectory '
                    f'{trajectory:.2e}, launches {first["launches"]}')
  return {'loss_rel': loss_rel, 'grad_rel': worst[1], 'grad_worst': worst[0],
          'trajectory_rel': trajectory, 'backends': sorted(backends),
          'steps_per_s': [r['steps_per_s'] for r in ranks],
          'losses': [r['losses'] for r in ranks]}


def check_ddp(card, failures):
  """Data-parallel training (parallel/distributed.py): two ranks sharing
  cuda:0 over gloo against one process on the global batch, world size 1
  over NCCL against the step without a group, and one rank a card over
  NCCL where there are several."""
  single = ddp_steps(torch.device('cuda'), data_parallel=False)
  report = {'single_steps_per_s': single['steps_per_s']}
  with tempfile.TemporaryDirectory() as out_dir:
    report['shared'] = compare_ranks('two ranks on cuda:0',
                                     run_ranks(2, out_dir), single, 'gloo',
                                     failures)
    nccl, = run_ranks(1, out_dir)
    alone = nccl['alone']
    grad_rel = max(((g - alone['grads'][n]).abs().max() /
                    alone['grads'][n].abs().max()).item()
                   for n, g in nccl['grads'].items())
    bit_equal = all(torch.equal(g, alone['grads'][n])
                    for n, g in nccl['grads'].items())
    launches_ok = all(l == STEP_LAUNCHES
                      for l in nccl['launches'] + alone['launches'])
    if not (nccl['backend'] == 'nccl' and alone['all_reduce_identity'] and
            nccl['losses'] == alone['losses'] and bit_equal and
            len(nccl['grads']) == 82 and launches_ok):
      failures.append(f'world size 1 over {nccl["backend"]}, captured, '
                      f'deterministic: losses {nccl["losses"]} vs '
                      f'{alone["losses"]}, all-reduce identity '
                      f'{alone["all_reduce_identity"]}, gradients bit-equal '
                      f'{bit_equal} (rel {grad_rel:.2e}), launches '
                      f'{nccl["launches"]} / {alone["launches"]}')
    report['nccl_world1'] = {'backend': nccl['backend'], 'grad_rel': grad_rel,
                             'grads_bit_equal': bit_equal,
                             'losses': nccl['losses'],
                             'steps_per_s': nccl['steps_per_s']}
    cards = torch.cuda.device_count()
    if cards > 1:
      report['per_card'] = compare_ranks(f'{cards} ranks, one a card',
                                         run_ranks(cards, out_dir), single,
                                         'nccl', failures)
  shared = report['shared']
  print(f'data-parallel: two ranks sharing cuda:0 over '
        f'{shared["backends"]} (global batch {TRAIN_BATCH}, 4 a rank, '
        f'released config, f32, TF32 and cuDNN off, the augmentations) vs '
        f'one process at batch {TRAIN_BATCH}: first loss rel '
        f'{shared["loss_rel"]:.2e} (bound {LOSS_REL_BOUND:.0e}), worst '
        f'averaged grad rel {shared["grad_rel"]:.2e} '
        f'({shared["grad_worst"]}, bound {GRAD_REL_BOUND:.0e}), '
        f'{DDP_STEPS}-step losses rel {shared["trajectory_rel"]:.2e} (bound '
        f'{DDP_TRAJECTORY_BOUND:.0e}); launches a step and rank '
        f'{STEP_LAUNCHES}; steps/s (TF32 allowed, {DDP_TIMED} after '
        f'{DDP_WARMUP}) two ranks {shared["steps_per_s"]}, one process '
        f'{single["steps_per_s"]:.3f}; on {card}')
  print(f'data-parallel: world size 1 over {nccl["backend"]}, the step '
        f'captured with its all-reduce, under deterministic algorithms, '
        f'against one process\'s captured step: losses of the warm-up and '
        f'the replay {nccl["losses"]} vs {alone["losses"]}, bit-equal '
        f'{nccl["losses"] == alone["losses"]}; the replay\'s 82 gradients '
        f'bit-equal {bit_equal} (worst rel {grad_rel:.1e}); the NCCL '
        f'all-reduce returns their bits {alone["all_reduce_identity"]}; '
        f'launches a step {nccl["launches"]}; steps/s (TF32 allowed, '
        f'{DDP_TIMED} after {DDP_WARMUP}) '
        f'{mean(nccl["steps_per_s"]["graphs"]):.3f} with graphs, '
        f'{mean(nccl["steps_per_s"]["eager"]):.3f} eager (turns g/e/e/g: '
        f'{nccl["steps_per_s"]}); '
        + (f'one rank a card over {report["per_card"]["backends"]}: '
           f'{report["per_card"]}' if 'per_card' in report else
           f'one rank a card: not run, {torch.cuda.device_count()} GPU')
        + f'; on {card}')
  return report


def graph_pair(card, failures):
  """The 1080p bf16 pair (released config, seed-0 weights and frames)
  through the pair program against graphs=False: agreement, launches
  through replays, ms a pair in turns, idle shares, the first call's
  seconds, capture seconds and the pool's bytes."""
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  graphs = Interpolator(model, options, align=64, device='cuda')
  eager = Interpolator(graphs.model, options, align=64, device='cuda',
                       graphs=False)
  frames = np.random.RandomState(0).rand(2, 1, 1080, 1920, 3).astype(
      np.float32)
  x0, x1 = (torch.from_numpy(f).cuda() for f in frames)
  dtd = torch.full((1,), 0.5, device='cuda')
  torch.cuda.synchronize()
  start = time.perf_counter()
  first = graphs.call_device(x0, x1, dtd)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - start
  program = graphs.programs['pair']
  capture = next(iter(program.captures.values()))
  replayed, launches, _ = run_counted(lambda: graphs.call_device(x0, x1,
                                                                 dtd))
  want = eager.call_device(x0, x1, dtd)
  max_abs = float((replayed - want).abs().max())
  first_abs = float((first - want).abs().max())
  psnr = psnr_db(replayed.cpu().numpy(), want.cpu().numpy())
  if launches != PAIR_LAUNCHES or capture.launches != PAIR_LAUNCHES:
    failures.append(f'graph pair launches {launches}, recorded '
                    f'{capture.launches} != {PAIR_LAUNCHES}')
  if not psnr >= GRAPH_PSNR_DB or not torch.isfinite(replayed).all():
    failures.append(f'graph pair vs eager {psnr:.2f} dB')
  ms = {'graphs': [], 'eager': []}
  for label in ('graphs', 'eager', 'eager', 'graphs'):
    interp = graphs if label == 'graphs' else eager
    ms[label].append(measure.time_ms(lambda: interp.call_device(x0, x1, dtd),
                                     iters=GRAPH_PAIR_ITERS, queued=False))
  idle = {label: measure.idle_share(lambda: interp.call_device(x0, x1, dtd),
                                    GRAPH_IDLE_PAIRS)
          for label, interp in (('graphs', graphs), ('eager', eager))}
  # The all-outputs program (the Interpolator's fifth): every output of
  # the forward, the image cropped, against the eager forward's.
  graphs.interpolate_all_outputs(x0, x1, dtd)
  outputs, all_launches, _ = run_counted(
      lambda: graphs.interpolate_all_outputs(x0, x1, dtd))
  eager_outputs = eager.interpolate_all_outputs(x0, x1, dtd)
  flat = flat_outputs(outputs)
  eager_flat = flat_outputs(eager_outputs)
  all_abs = {name: float((t.float() - eager_flat[name].float()).abs().max())
             for name, t in flat.items()}
  if flat.keys() != eager_flat.keys() or max(all_abs.values()) != 0.0 or (
      all_launches != PAIR_LAUNCHES) or outputs['image'].shape != (
          1, 1080, 1920, 3):
    failures.append(f'graph all-outputs vs eager: max-abs {all_abs}, '
                    f'launches {all_launches}')
  del outputs, eager_outputs, flat, eager_flat
  report = {'max_abs': max_abs, 'first_call_max_abs': first_abs,
            'psnr': psnr, 'launches': launches, 'ms': ms, 'idle': idle,
            'first_call_s': first_s,
            'capture_s': capture.capture_seconds,
            'pool_bytes': program.pool_bytes,
            'all_outputs_max_abs': all_abs,
            'all_outputs_launches': all_launches,
            'all_outputs_pool_bytes': graphs.programs['all_outputs'].pool_bytes}
  print(f'graphs: 1080p bf16 pair (released config): replay vs eager '
        f'max-abs {max_abs:.3e} (first call, the warm-up, {first_abs:.1e}), '
        f'{psnr:.2f} dB (bound {GRAPH_PSNR_DB}); launches a replay '
        f'{launches}; ms a pair {mean(ms["graphs"]):.3f} with graphs, '
        f'{mean(ms["eager"]):.3f} eager (CUDA events, {GRAPH_PAIR_ITERS} '
        f'pairs, turns g/e/e/g: {ms}); idle share {idle_text(idle)}; first '
        f'call {first_s:.3f} s of which capture {capture.capture_seconds:.3f}'
        f' s, pool {program.pool_bytes / 2**30:.2f} GiB; all-outputs program '
        f'({len(all_abs)} outputs) vs eager max-abs '
        f'{max(all_abs.values()):.1e}, launches a replay {all_launches}, '
        f'pool {report["all_outputs_pool_bytes"] / 2**30:.2f} GiB; on {card}')
  return report


def flat_outputs(outputs):
  """name -> tensor of every output of the forward, pyramids by level."""
  flat = {}
  for name, value in outputs.items():
    if isinstance(value, (list, tuple)):
      for level, t in enumerate(value):
        flat[f'{name}/{level}'] = t
    else:
      flat[name] = value
  return flat


def graph_mixed(card, failures):
  """One default Interpolator (released config, bf16) serving the pairs
  of MIXED_KEYS in turn, as a server meets frame sizes and batch sizes:
  each against graphs=False, and the device memory its graphs hold. The
  pool's budget bounds it: after each call the memory reserved beyond
  the start stays under the budget plus the largest graph plus
  MIXED_SLACK_BYTES, and at any time under the budget plus the larger of
  the largest graph and the largest eager call, plus the slack."""
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  eager = Interpolator(model, options, align=64, device='cuda', graphs=False)
  rng = np.random.RandomState(3)
  inputs, wants, eager_peak = {}, {}, 0
  for key in dict.fromkeys(MIXED_KEYS):
    height, width, batch = key
    x0, x1 = (torch.from_numpy(rng.rand(batch, height, width, 3).astype(
        np.float32)).cuda() for _ in range(2))
    inputs[key] = (x0, x1, torch.full((batch,), 0.5, device='cuda'))
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_reserved()
    wants[key] = eager.interpolate_device(*inputs[key]).cpu()
    eager_peak = max(eager_peak, torch.cuda.max_memory_reserved() - start)
  graphs = Interpolator(eager.model, options, align=64, device='cuda')
  del eager
  pool = graphs.programs['pair'].pool
  budget = int(programs.POOL_BUDGET_SHARE *
               torch.cuda.get_device_properties(0).total_memory)
  release_memory()
  base = torch.cuda.memory_reserved()
  torch.cuda.reset_peak_memory_stats()
  calls, largest, grown, worst_abs, worst_db = [], 0, 0, 0.0, float('inf')
  for key in MIXED_KEYS:
    before = live_captures(graphs)
    out = graphs.interpolate_device(*inputs[key])
    torch.cuda.synchronize()
    out = out.cpu()
    worst_abs = max(worst_abs, float((out - wants[key]).abs().max()))
    worst_db = min(worst_db, psnr_db(out.numpy(), wants[key].numpy()))
    del out
    captured = new_captures(graphs, before).get('pair', [])
    largest = max([largest] + captured)
    grown += sum(captured)
    held = torch.cuda.memory_reserved() - base
    calls.append({'key': key, 'held_bytes': held, 'pool_bytes': pool.bytes,
                  'graphs': len(graphs.programs['pair'].captures),
                  'clears': pool.clears, 'captured_bytes': captured})
  peak = torch.cuda.max_memory_reserved() - base
  held_bound = budget + largest + MIXED_SLACK_BYTES
  peak_bound = budget + max(largest, eager_peak) + MIXED_SLACK_BYTES
  held = max(c['held_bytes'] for c in calls)
  if not worst_db >= GRAPH_PSNR_DB or held > held_bound or (
      peak > peak_bound) or not pool.clears:
    failures.append(f'mixed serving: {worst_db:.2f} dB vs eager, held '
                    f'{held / 2**30:.2f} GiB (bound {held_bound / 2**30:.2f}'
                    f'), peak {peak / 2**30:.2f} GiB (bound '
                    f'{peak_bound / 2**30:.2f}), {pool.clears} clears')
  gib = lambda n: round(n / 2**30, 2)
  print(f'graphs: mixed serving through one default Interpolator (released '
        f'config, bf16; (H, W, batch) {list(MIXED_KEYS)}): vs eager max-abs '
        f'{worst_abs:.1e}, {worst_db:.2f} dB (bound {GRAPH_PSNR_DB}); memory held beyond the start after each call '
        f'{[gib(c["held_bytes"]) for c in calls]} GiB, each call\'s '
        f'captures grew the pool by '
        f'{[[gib(b) for b in c["captured_bytes"]] for c in calls]}, the pool '
        f'{[gib(c["pool_bytes"]) for c in calls]}, graphs '
        f'{[c["graphs"] for c in calls]}, clears after each call '
        f'{[c["clears"] for c in calls]}: emptied {pool.clears} times by its '
        f'budget of {gib(budget)} GiB; most held {gib(held)} GiB (bound '
        f'{gib(held_bound)}: budget + largest graph {gib(largest)} + '
        f'{gib(MIXED_SLACK_BYTES)}), peak {gib(peak)} (bound '
        f'{gib(peak_bound)}, largest eager call {gib(eager_peak)}); the '
        f'graphs captured grew pools by {gib(grown)} GiB in all; on {card}')
  return {'calls': calls, 'max_abs': worst_abs, 'psnr': worst_db,
          'budget_bytes': budget,
          'largest_graph_bytes': largest, 'eager_peak_bytes': eager_peak,
          'held_bytes': held, 'peak_bytes': peak, 'grown_bytes': grown,
          'clears': pool.clears}


def mean(values) -> float:
  return sum(values) / len(values)


def idle_text(idle) -> str:
  return ', '.join(
      f'{label} ' + ('not measured (no kernel in the trace)'
                     if r['idle'] is None else
                     f'{r["idle"]:.3f} ({r["busy_ms"]:.3f} ms busy of '
                     f'{r["wall_ms"]:.3f})')
      for label, r in idle.items())


def graph_tree(card, failures):
  """The 17-frame cached tree (3 uint8 1080p frames, T = 3) through the
  tree program against graphs=False: agreement, launches through
  replays, ms per output frame and peak memory of each."""
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  interps = {'graphs': Interpolator(model, options, align=64,
                                    device='cuda')}
  interps['eager'] = Interpolator(interps['graphs'].model, options, align=64,
                                  device='cuda', graphs=False)
  frames = torch.from_numpy(np.random.RandomState(0).randint(
      0, 256, (VIDEO_FRAMES, VIDEO_H, VIDEO_W, 3)).astype(np.uint8)).cuda()
  report, outs = {}, {}

  def tree(label):
    return interps[label].expand_tree_device(frames, VIDEO_TIMES)

  for label in ('graphs', 'eager'):
    torch.cuda.synchronize()
    start = time.perf_counter()
    _, first_launches, first_peak = run_counted(lambda: tree(label))
    first_s = time.perf_counter() - start
    out, launches, peak = run_counted(lambda: tree(label))
    outs[label] = out.cpu().numpy()
    if launches != CACHED_TREE_LAUNCHES or (
        first_launches != CACHED_TREE_LAUNCHES):
      failures.append(f'{label} tree launches {first_launches} then '
                      f'{launches} != {CACHED_TREE_LAUNCHES}')
    report[label] = {'first_s': first_s, 'first_peak_bytes': first_peak,
                     'peak_bytes': peak, 'launches': launches}
  for label in ('graphs', 'eager', 'eager', 'graphs'):
    report[label].setdefault('ms', []).append(measure.time_ms(
        lambda: tree(label), iters=2, queued=False))
  programs_ = interps['graphs'].programs
  report['pool_bytes'] = {name: p.pool_bytes for name, p in programs_.items()}
  report['capture_s'] = {
      name: sum(c.capture_seconds for c in p.captures.values())
      for name, p in programs_.items()}
  psnr = min_frame_psnr(outs['graphs'], outs['eager'])
  max_abs = float(np.abs(outs['graphs'] - outs['eager']).max())
  report.update(psnr=psnr, max_abs=max_abs)
  if outs['graphs'].shape != (VIDEO_OUTPUTS, VIDEO_H, VIDEO_W, 3) or not (
      psnr >= GRAPH_PSNR_DB):
    failures.append(f'graph tree {outs["graphs"].shape}, {psnr:.2f} dB vs '
                    'eager')
  per_frame = {label: mean(report[label]['ms']) / VIDEO_OUTPUTS
               for label in ('graphs', 'eager')}
  print(f'graphs: {VIDEO_OUTPUTS}-frame cached tree (3 uint8 1080p frames, '
        f'T = {VIDEO_TIMES}, bf16): replay vs eager min frame {psnr:.2f} dB, '
        f'max-abs {max_abs:.3e} (bound {GRAPH_PSNR_DB} dB); ms per output '
        f'frame {per_frame["graphs"]:.3f} with graphs, {per_frame["eager"]:.3f}'
        f' eager (turns g/e/e/g, ms a tree {report["graphs"]["ms"]}, '
        f'{report["eager"]["ms"]}); peak memory '
        f'{report["graphs"]["peak_bytes"] / 2**30:.2f} GiB a replay '
        f'({report["graphs"]["first_peak_bytes"] / 2**30:.2f} at the capture),'
        f' {report["eager"]["peak_bytes"] / 2**30:.2f} eager; first call '
        f'{report["graphs"]["first_s"]:.2f} s, capture s '
        f'{ {k: round(v, 3) for k, v in report["capture_s"].items()} }, pools '
        f'{ {k: round(v / 2**30, 2) for k, v in report["pool_bytes"].items()} }'
        f' GiB; launches a replayed tree {report["graphs"]["launches"]}; on '
        f'{card}')
  return report


def train_state_tensors(state):
  """A TrainState's parameters and its optimizer's state tensors, in one
  order."""
  out = []
  for p in state.model.parameters():
    out.append(p)
    out.extend(v for _, v in sorted(state.optimizer.state[p].items()))
  return out


def copy_tensors(dst, src):
  with torch.no_grad():
    for d, t in zip(dst, src):
      d.copy_(t)


def max_rel(model, reference):
  """The largest max|p - q| / max|q| over the two models' parameter
  tensors, and its tensor's name."""
  worst, name = 0.0, ''
  ref = dict(reference.named_parameters())
  for n, p in model.named_parameters():
    rel = ((p - ref[n]).abs().max() / ref[n].abs().max().clamp_min(
        1e-30)).item()
    if rel > worst:
      worst, name = rel, n
  return worst, name


def graph_step(label, config, losses, step0, card, failures):
  """film_net-L1 or -Style (released config, f32, batch 8 of 256x256,
  the augmentations, TF32 allowed): the captured lean step against the
  eager one from the same state, steps/s and peak memory of each, and
  train_lib.train for GRAPH_LOOP_STEPS steps in both."""
  options = config.model
  augs = tuple(config.augmentations)
  opts = train_lib.TrainingOptions()
  model = init_params(create_model(options),
                      torch.Generator().manual_seed(0)).cuda()
  states = {'graphs': train_lib.create_train_state(model, opts),
            'eager': train_lib.create_train_state(copy.deepcopy(model), opts)}
  step_fns = {'graphs': train_lib.make_train_step(losses, opts, augs,
                                                  with_summaries=False),
              'eager': train_lib.make_train_step(losses, opts, augs,
                                                 with_summaries=False,
                                                 graphs=False)}
  rng = np.random.RandomState(7)
  batches = [train_lib.batch_to_device(square_batch(rng),
                                       torch.device('cuda'))
             for _ in range(2)]
  metrics, grads, launches, first_s = {}, {}, {}, 0.0
  with tf32_allowed(True):
    for turn, state in states.items():
      state.step = step0
      torch.cuda.synchronize()
      start = time.perf_counter()
      # The first step: the graphs' warm-up (eager) and capture; the
      # eager side's makes its Adam state.
      step_fns[turn](state, batches[0],
                     train_lib.step_generator(0, state.step))
      torch.cuda.synchronize()
      if turn == 'graphs':
        first_s = time.perf_counter() - start
    # Both sides from the graphs side's state, bit for bit (copied in
    # place: the graph reads these buffers), then one step each: the
    # graph's replay and the eager step.
    copy_tensors(train_state_tensors(states['eager']),
                 train_state_tensors(states['graphs']))
    before = [t.clone() for t in train_state_tensors(states['graphs'])]
    step = states['graphs'].step
    for turn, state in states.items():
      (metrics[turn], _), launches[turn], _ = run_counted(
          lambda: step_fns[turn](state, batches[1],
                                 train_lib.step_generator(0, step)))
      grads[turn] = [p.grad.detach().clone()
                     for p in state.model.parameters()]
      if launches[turn] != under_tf32(STEP_LAUNCHES):
        failures.append(f'{label} {turn} step launches {launches[turn]}')
    # Each side's parameters after its own step.
    free_rel, free_worst = max_rel(states['graphs'].model,
                                   states['eager'].model)
    # The update alone: the eager side back at the step's start, given the
    # replay's gradients, one eager Adam step at the same rate.
    copy_tensors(train_state_tensors(states['eager']), before)
    for p, g in zip(states['eager'].model.parameters(), grads['graphs']):
      p.grad = g.clone()
    # The same update by a plain Adam (not capturable, a float rate, the
    # trainer's eps), the form the capturable one replaced on the card. They
    # differ by f32 rounding: the capturable form computes 1 - beta2^t in
    # f32 on the device (3e-5 relative at t = 2), and a bias near 0 is the
    # small sum of two updates, so its relative difference is larger.
    lr = train_lib.learning_rate_schedule(opts)(step)
    plain_model = copy.deepcopy(states['eager'].model)
    plain = torch.optim.Adam(plain_model.parameters(), lr=lr, eps=1e-7)
    for p, q in zip(states['eager'].model.parameters(),
                    plain_model.parameters()):
      kept = states['eager'].optimizer.state[p]
      plain.state[q] = {'step': kept['step'].detach().float().cpu(),
                        'exp_avg': kept['exp_avg'].clone(),
                        'exp_avg_sq': kept['exp_avg_sq'].clone()}
      q.grad = p.grad.clone()
    plain.step()
    train_lib.set_learning_rate(states['eager'].optimizer, lr)
    states['eager'].optimizer.step()
    del before
  program = step_fns['graphs'].programs()[0]
  capture = next(iter(program.captures.values()))
  loss = {k: float(m['training_loss']) for k, m in metrics.items()}
  loss_rel = abs(loss['graphs'] - loss['eager']) / abs(loss['eager'])
  grad_rel, grad_worst = 0.0, ''
  for (name, _), g, e in zip(model.named_parameters(), grads['graphs'],
                             grads['eager']):
    rel = ((g - e).abs().max() / e.abs().max().clamp_min(1e-30)).item()
    if rel > grad_rel:
      grad_rel, grad_worst = rel, name
  del grads
  param_rel, worst = max_rel(states['graphs'].model, states['eager'].model)
  plain_rel, plain_worst = max_rel(states['graphs'].model, plain_model)
  del plain_model, plain
  if not plain_rel <= GRAPH_STEP_REL_BOUND:
    failures.append(f'{label} captured step vs a plain Adam given the same '
                    f'gradients: parameters rel {plain_rel:.3e} '
                    f'({plain_worst})')
  if not loss_rel <= GRAPH_STEP_REL_BOUND or not (
      grad_rel <= GRAD_REL_BOUND) or not param_rel <= GRAPH_STEP_REL_BOUND or (
          not free_rel <= GRAPH_STEP_REL_BOUND):
    failures.append(f'{label} captured step vs eager: loss rel '
                    f'{loss_rel:.3e}, gradients rel {grad_rel:.3e} '
                    f'({grad_worst}), parameters rel {param_rel:.3e} '
                    f'({worst}) given the same gradients, {free_rel:.3e} '
                    f'({free_worst}) from their own')
  rates, peaks = {'graphs': [], 'eager': []}, {}
  batch_iter = (train_lib.batch_to_device(b, torch.device('cuda'))
                for b in square_batches(8))
  with tf32_allowed(True):
    for turn in ('graphs', 'eager', 'eager', 'graphs'):
      torch.cuda.reset_peak_memory_stats()
      rates[turn].append(steps_per_second(states[turn], step_fns[turn],
                                          batch_iter))
      peaks[turn] = torch.cuda.max_memory_allocated()
    fixed = batches[1]
    idle = {turn: measure.idle_share(
        lambda: step_fns[turn](states[turn], fixed, torch.Generator()),
        GRAPH_IDLE_STEPS) for turn in ('graphs', 'eager')}
  pool_bytes = program.pool_bytes
  del states, step_fns, program, model
  release_memory()

  # The loop: a logging step (eager) at GRAPH_LOG_INTERVAL and the last.
  runs = {}
  with tempfile.TemporaryDirectory() as work:
    for turn in ('graphs', 'eager'):
      lines = []
      loop_opts = train_lib.TrainingOptions(
          num_steps=GRAPH_LOOP_STEPS, save_interval=GRAPH_LOG_INTERVAL,
          timing_interval=GRAPH_LOG_INTERVAL)
      _kernels.reset_launch_counts()
      start = time.perf_counter()
      state = train_lib.train(
          create_model(options), options, losses, square_batches(9),
          loop_opts, os.path.join(work, turn), device='cuda',
          augmentation_names=augs, log_fn=lines.append,
          graphs=None if turn == 'graphs' else False)
      torch.cuda.synchronize()
      runs[turn] = {
          'seconds': time.perf_counter() - start,
          'launches': _kernels.launch_counts(),
          'losses': [float(v) for line in lines for v in re.findall(
              r'training_loss=([-+.\deE]+|nan|inf)', line)],
          'params': {n: p.detach().clone()
                     for n, p in state.model.named_parameters()}}
      del state
  track_rel = max(abs(a - b) / abs(b) for a, b in zip(
      runs['graphs']['losses'], runs['eager']['losses']))
  loop_param_rel = max(
      ((p - runs['eager']['params'][n]).abs().max() /
       runs['eager']['params'][n].abs().max().clamp_min(1e-30)).item()
      for n, p in runs['graphs']['params'].items())
  want_launches = under_tf32({k: GRAPH_LOOP_STEPS * v
                              for k, v in STEP_LAUNCHES.items()})
  if len(runs['graphs']['losses']) != 2 or not (
      track_rel <= GRAPH_TRACK_REL_BOUND):
    failures.append(f'{label} loop losses {runs["graphs"]["losses"]} vs '
                    f'eager {runs["eager"]["losses"]}')
  if runs['graphs']['launches'] != want_launches:
    failures.append(f'{label} captured loop launches '
                    f'{runs["graphs"]["launches"]}')
  for run in runs.values():
    del run['params']
  report = {'loss_rel': loss_rel, 'grad_rel': grad_rel,
            'worst_grad': grad_worst, 'param_rel': param_rel,
            'worst_param': worst, 'plain_adam_rel': plain_rel,
            'plain_adam_worst': plain_worst, 'free_param_rel': free_rel,
            'free_worst_param': free_worst, 'loss': loss,
            'launches': launches, 'steps_per_s': rates,
            'peak_bytes': peaks, 'idle': idle, 'first_step_s': first_s,
            'capture_s': capture.capture_seconds, 'pool_bytes': pool_bytes,
            'loop': runs, 'loop_loss_rel': track_rel,
            'loop_param_rel': loop_param_rel}
  print(f'graphs: {label} step (released config, f32, batch {TRAIN_BATCH}x'
        f'{TRAIN_CROP}x{TRAIN_CROP}, {list(augs)}, TF32 allowed, from step '
        f'{step0}): the replayed step vs the eager step from the same state'
        f', loss rel {loss_rel:.2e} (bound {GRAPH_STEP_REL_BOUND:.0e}), '
        f'gradients rel {grad_rel:.2e} ({grad_worst}; bound '
        f'{GRAD_REL_BOUND:.0e}), parameters rel {param_rel:.2e} given the '
        f'same gradients ({worst}), {free_rel:.2e} from their own '
        f'({free_worst}; bound {GRAPH_STEP_REL_BOUND:.0e}), {plain_rel:.2e} '
        f'against a plain Adam given the same gradients ({plain_worst}; '
        f'bound {GRAPH_STEP_REL_BOUND:.0e}); launches '
        f'{launches["graphs"]}; steps/s {mean(rates["graphs"]):.3f} '
        f'with graphs, {mean(rates["eager"]):.3f} eager (turns g/e/e/g: '
        f'{rates}); peak memory {peaks["graphs"] / 2**30:.2f} GiB with '
        f'graphs beside its pool, {peaks["eager"] / 2**30:.2f} eager; idle '
        f'share '
        f'{idle_text(idle)}; first step {first_s:.2f} s, capture '
        f'{capture.capture_seconds:.3f} s, pool {pool_bytes / 2**30:.2f} GiB;'
        f' train_lib.train {GRAPH_LOOP_STEPS} steps (logging at '
        f'{GRAPH_LOG_INTERVAL}): losses {runs["graphs"]["losses"]} vs eager '
        f'{runs["eager"]["losses"]}, rel {track_rel:.2e} (bound '
        f'{GRAPH_TRACK_REL_BOUND:.0e}), final parameters rel '
        f'{loop_param_rel:.2e}, {runs["graphs"]["seconds"]:.1f} s vs '
        f'{runs["eager"]["seconds"]:.1f} s, launches '
        f'{runs["graphs"]["launches"]}; on {card}')
  return report


def grad_rel_of(model_a, grads_a, grads_b):
  """The largest max|a - b| / max|b| over the parameters' gradients, and
  its parameter's name."""
  worst, name = 0.0, ''
  for (n, _), a, b in zip(model_a.named_parameters(), grads_a, grads_b):
    rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
    if rel > worst:
      worst, name = rel, n
  return worst, name


def graph_summary_step(card, failures):
  """The summary step (with_summaries=True, the logging steps' variant) as
  its own program, sharing one pool with the lean step as train_loop gives
  them: from one state, the replay against the eager summary step under
  the graph-step bounds, its images against eager's, launches, and the
  pool's bytes of each variant (film_net-L1, released config, f32, batch
  8 of 256x256, the augmentations, TF32 allowed)."""
  config = configs.get_experiment('film_net-L1')
  losses = losses_lib.training_losses(['l1'])
  augs = tuple(config.augmentations)
  opts = train_lib.TrainingOptions()
  model = init_params(create_model(config.model),
                      torch.Generator().manual_seed(0)).cuda()
  states = {'graphs': train_lib.create_train_state(model, opts),
            'eager': train_lib.create_train_state(copy.deepcopy(model), opts)}
  pool = programs.Pool()
  lean = train_lib.make_train_step(losses, opts, augs, with_summaries=False,
                                   pool=pool)
  step_fns = {'graphs': train_lib.make_train_step(losses, opts, augs,
                                                  with_summaries=True,
                                                  pool=pool),
              'eager': train_lib.make_train_step(losses, opts, augs,
                                                 with_summaries=True,
                                                 graphs=False)}
  rng = np.random.RandomState(11)
  batches = [train_lib.batch_to_device(square_batch(rng),
                                       torch.device('cuda'))
             for _ in range(3)]
  outs, grads, launches = {}, {}, {}
  with tf32_allowed(True):
    # The lean step's capture, then the summary step's, in one pool; the
    # eager side's first step makes its Adam state.
    state = states['graphs']
    for fn, batch in ((lean, batches[0]), (lean, batches[0]),
                      (step_fns['graphs'], batches[1])):
      fn(state, batch, train_lib.step_generator(0, state.step))
    step_fns['eager'](states['eager'], batches[0],
                      train_lib.step_generator(0, 0))
    torch.cuda.synchronize()
    lean_bytes = lean.programs()[0].pool_bytes
    summary_bytes = step_fns['graphs'].programs()[0].pool_bytes
    copy_tensors(train_state_tensors(states['eager']),
                 train_state_tensors(states['graphs']))
    states['eager'].step = step = states['graphs'].step
    for turn, st in states.items():
      outs[turn], launches[turn], _ = run_counted(
          lambda: step_fns[turn](st, batches[2],
                                 train_lib.step_generator(0, step)))
      grads[turn] = [p.grad.detach().clone() for p in st.model.parameters()]
  (metrics_g, images_g), (metrics_e, images_e) = outs['graphs'], outs['eager']
  loss = {k: float(m['training_loss']) for k, m in (('graphs', metrics_g),
                                                    ('eager', metrics_e))}
  loss_rel = abs(loss['graphs'] - loss['eager']) / abs(loss['eager'])
  grad_rel, grad_worst = grad_rel_of(model, grads['graphs'], grads['eager'])
  param_rel, param_worst = max_rel(states['graphs'].model,
                                   states['eager'].model)
  image_abs = {k: float((v - images_e[k]).abs().max())
               for k, v in images_g.items()}
  if not (loss_rel <= GRAPH_STEP_REL_BOUND and grad_rel <= GRAD_REL_BOUND
          and param_rel <= GRAPH_STEP_REL_BOUND) or (
              images_g.keys() != images_e.keys() or
              max(image_abs.values()) != 0.0) or (
                  launches['graphs'] != under_tf32(STEP_LAUNCHES)):
    failures.append(f'graph summary step vs eager: loss rel {loss_rel:.3e}, '
                    f'gradients rel {grad_rel:.3e} ({grad_worst}), '
                    f'parameters rel {param_rel:.3e} ({param_worst}), '
                    f'images max-abs {image_abs}, launches '
                    f'{launches["graphs"]}')
  report = {'loss_rel': loss_rel, 'grad_rel': grad_rel,
            'param_rel': param_rel, 'image_max_abs': image_abs,
            'launches': launches, 'lean_pool_bytes': lean_bytes,
            'summary_pool_bytes': summary_bytes,
            'pool_bytes': pool.bytes}
  print(f'graphs: the summary step (film_net-L1, released config, f32, '
        f'batch {TRAIN_BATCH}x{TRAIN_CROP}x{TRAIN_CROP}, TF32 allowed) as its '
        f'own program beside the lean one: replay vs eager from one state, '
        f'loss rel {loss_rel:.2e} (bound {GRAPH_STEP_REL_BOUND:.0e}), '
        f'gradients rel {grad_rel:.2e} ({grad_worst}; bound '
        f'{GRAD_REL_BOUND:.0e}), parameters rel {param_rel:.2e} (bound '
        f'{GRAPH_STEP_REL_BOUND:.0e}); its {len(images_g)} images vs eager '
        f'max-abs {max(image_abs.values()):.1e}; launches '
        f'{launches["graphs"]}; one pool: lean {lean_bytes / 2**30:.2f} GiB '
        f'+ summary {summary_bytes / 2**30:.2f} GiB = '
        f'{pool.bytes / 2**30:.2f} GiB; on {card}')
  del states, step_fns, lean, model, outs, grads
  pool.clear()
  return report


@contextlib.contextmanager
def deterministic():
  """torch.use_deterministic_algorithms(True) while the block runs (cuBLAS
  reads CUBLAS_WORKSPACE_CONFIG, set when this script starts)."""
  saved = torch.are_deterministic_algorithms_enabled()
  torch.use_deterministic_algorithms(True)
  try:
    yield
  finally:
    torch.use_deterministic_algorithms(saved)


def replays_from_one_state(state, model, step_fn, batches, snapshot, step):
  """Two replays of the captured step from the state `snapshot` holds:
  each run's loss, gradients, parameters and launches. The caller has
  captured the step under the switches in force."""
  runs = []
  for _ in range(2):
    copy_tensors(train_state_tensors(state), snapshot)
    state.step = step
    (metrics, _), launches, _ = run_counted(
        lambda: step_fn(state, batches[1], train_lib.step_generator(0, step)))
    runs.append({'loss': metrics['training_loss'].clone(),
                 'grads': [p.grad.detach().clone()
                           for p in model.parameters()],
                 'params': [p.detach().clone() for p in model.parameters()],
                 'launches': launches})
  return runs


def compare_runs(a, b, names):
  """Bit-equality of two runs' loss, gradients and parameters; the
  parameters whose gradients differ, in the model's order, with the
  max-abs of each."""
  differ = [(n, float((x - y).abs().max()))
            for n, x, y in zip(names, a['grads'], b['grads'])
            if not torch.equal(x, y)]
  return {'loss_equal': torch.equal(a['loss'], b['loss']),
          'grads_equal': not differ,
          'params_equal': all(torch.equal(x, y)
                              for x, y in zip(a['params'], b['params'])),
          'grad_max_abs': max(float((x - y).abs().max())
                              for x, y in zip(a['grads'], b['grads'])),
          'grads_differ': differ}


def describe_differ(result, count) -> str:
  differ = result['grads_differ']
  if not differ:
    return f'all {count} gradients bit-equal'
  largest = max(differ, key=lambda d: d[1])
  first = ', '.join(f'{n} ({v:.1e})' for n, v in differ[:5])
  return (f'{len(differ)} of {count} gradients differ, first in the '
          f"model's order: {first}; largest {largest[0]} ({largest[1]:.1e})")


def determinism_step(label, config, losses, step0, card, failures,
                     default_mode=False):
  """Under torch.use_deterministic_algorithms(True) (cuDNN's deterministic
  algorithms; the splat sums in its fixed order in every mode): two
  replays of the captured step from one state, bit for bit in the loss,
  every gradient and every parameter; launches a step; steps/s with and
  without the mode in turns (released config, f32, batch 8 of 256x256,
  the augmentations, TF32 allowed). With `default_mode`, also two replays
  from the same state without the mode, reported and not gated: where
  they differ, the parameters whose gradients differ, and two replays
  with torch.backends.cudnn.deterministic alone, which names cuDNN's
  default algorithms if they are then bit-equal."""
  augs = tuple(config.augmentations)
  opts = train_lib.TrainingOptions()
  model = init_params(create_model(config.model),
                      torch.Generator().manual_seed(0)).cuda()
  names = [n for n, _ in model.named_parameters()]
  state = train_lib.create_train_state(model, opts)
  step_fn = train_lib.make_train_step(losses, opts, augs,
                                      with_summaries=False)
  rng = np.random.RandomState(12)
  batches = [train_lib.batch_to_device(square_batch(rng),
                                       torch.device('cuda'))
             for _ in range(2)]
  with tf32_allowed(True), deterministic():
    state.step = step0
    step_fn(state, batches[0], train_lib.step_generator(0, state.step))
    # Detached: a clone of a parameter would keep its gradient
    # accumulator, made on this stream, alive into the next capture.
    snapshot = [t.detach().clone() for t in train_state_tensors(state)]
    step = state.step
    runs = replays_from_one_state(state, model, step_fn, batches, snapshot,
                                  step)
  a, b = runs
  report = compare_runs(a, b, names)
  report['launches'] = a['launches']
  if not (report['loss_equal'] and report['grads_equal'] and
          report['params_equal']) or any(
              r['launches'] != under_tf32(STEP_LAUNCHES) for r in runs):
    failures.append(f'{label} deterministic graph steps: loss equal '
                    f'{report["loss_equal"]}, gradients equal '
                    f'{report["grads_equal"]} (max-abs '
                    f'{report["grad_max_abs"]:.3e}), parameters equal '
                    f'{report["params_equal"]}, launches '
                    f'{[r["launches"] for r in runs]}')
  if default_mode:
    # The default mode's step, captured under its own key from the same
    # state; then, where its replays differ, cuDNN's switch alone.
    report['default'] = {}
    for variant in ('default', 'cudnn_deterministic'):
      with tf32_allowed(True), (
          contextlib.nullcontext() if variant == 'default' else
          torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                     deterministic=True, allow_tf32=True)):
        copy_tensors(train_state_tensors(state), snapshot)
        state.step = step
        step_fn(state, batches[0], train_lib.step_generator(0, step))
        pair = replays_from_one_state(state, model, step_fn, batches,
                                      snapshot, step)
      result = compare_runs(*pair, names)
      result['vs_deterministic_loss_equal'] = torch.equal(pair[0]['loss'],
                                                          a['loss'])
      result['vs_deterministic_grad_max_abs'] = max(
          float((x - y).abs().max())
          for x, y in zip(pair[0]['grads'], a['grads']))
      result['launches'] = pair[0]['launches']
      report['default'][variant] = result
      print(f'determinism: {label} in the {variant.replace("_", ".")} mode '
            f'(no torch.use_deterministic_algorithms; TF32 allowed, from '
            f'step {step0}): two replayed graph steps from one state, loss '
            f'bit-equal {result["loss_equal"]}, '
            f'{describe_differ(result, len(names))} (max-abs '
            f'{result["grad_max_abs"]:.1e}), parameters bit-equal '
            f'{result["params_equal"]}; against the deterministic mode\'s '
            f'replay: loss bit-equal {result["vs_deterministic_loss_equal"]}, '
            f'gradients max-abs {result["vs_deterministic_grad_max_abs"]:.1e};'
            f' launches {result["launches"]}; on {card}')
      if result['grads_equal'] and result['loss_equal']:
        break
    del pair
  del runs, snapshot
  rates = {'deterministic': [], 'default': []}
  batch_iter = (train_lib.batch_to_device(b, torch.device('cuda'))
                for b in square_batches(13))
  profiles = {}
  with tf32_allowed(True):
    for turn in ('deterministic', 'default', 'default', 'deterministic'):
      with (deterministic() if turn == 'deterministic'
            else contextlib.nullcontext()):
        rates[turn].append(steps_per_second(state, step_fn, batch_iter))
    # The splat's device ms a step in each mode (its kernels' names start
    # with splat_; one route in both), beside the step's busy ms.
    for turn in ('deterministic', 'default'):
      with (deterministic() if turn == 'deterministic'
            else contextlib.nullcontext()):
        profiles[turn] = measure.idle_share(
            lambda: step_fn(state, batches[1], torch.Generator()),
            GRAPH_IDLE_STEPS, named=('splat_',))
  splat_ms = {k: v['named']['splat_'] for k, v in profiles.items()}
  report.update(steps_per_s=rates, splat_ms=splat_ms,
                busy_ms={k: v['busy_ms'] for k, v in profiles.items()})
  print(f'determinism: {label} (released config, f32, batch {TRAIN_BATCH}x'
        f'{TRAIN_CROP}x{TRAIN_CROP}, {list(augs)}, TF32 allowed, from step '
        f'{step0}) under torch.use_deterministic_algorithms(True): two '
        f'replayed graph steps from one state, loss bit-equal '
        f'{report["loss_equal"]}, {describe_differ(report, len(names))} '
        f'(max-abs {report["grad_max_abs"]:.1e}), parameters bit-equal '
        f'{report["params_equal"]}; launches {report["launches"]}; graph '
        f'steps/s {mean(rates["deterministic"]):.3f} deterministic, '
        f'{mean(rates["default"]):.3f} default (turns d/D/D/d: {rates}); '
        f'the splat\'s device ms a step (torch.profiler, '
        f'{GRAPH_IDLE_STEPS} replays) {splat_ms["deterministic"]:.3f} '
        f'deterministic, {splat_ms["default"]:.3f} default, of '
        f'{report["busy_ms"]["deterministic"]:.3f} and '
        f'{report["busy_ms"]["default"]:.3f} ms busy a step; on {card}')
  del state, step_fn, model
  release_memory()
  return report


def check_determinism(mat_path, card, failures):
  """Reproducible training (ROADMAP C13): film_net-L1 and -Style graph
  steps under deterministic mode, and film_net-L1 in the default mode."""
  l1 = configs.get_experiment('film_net-L1')
  report = {'film_net-L1': determinism_step(
      'film_net-L1', l1, losses_lib.training_losses(['l1']), 0, card,
      failures, default_mode=True)}
  style = configs.get_experiment('film_net-Style', mat_path)
  report['film_net-Style'] = determinism_step(
      'film_net-Style', style, losses_lib.training_losses(
          list(style.training_losses.names),
          loss_weight_schedules=list(style.training_losses.weight_schedules),
          vgg_model_file=style.vgg_model_file), STYLE_STEP, card, failures)
  return report


def graph_sharded(card, failures):
  """The 2x2 patches of a 1080p pair over [cuda:0] * 4 with and without
  graphs (each shard replays its own pair program from its thread): ms a
  pair; then the row-sharded pair (graph_rows)."""
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  mesh = parallel_mesh.Mesh(['cuda:0'] * SHARDS)
  frames = np.random.RandomState(1).rand(2, 1, VIDEO_H, VIDEO_W, 3).astype(
      np.float32)
  x0, x1 = (torch.from_numpy(f).cuda() for f in frames)
  dtd = torch.full((1,), 0.5, device='cuda')
  interps = {label: sharded.ShardedInterpolator(
      model, options, mesh, (2, 2), align=64, graphs=label == 'graphs')
             for label in ('graphs', 'eager')}
  outs, launches = {}, {}
  for label, interp in interps.items():
    interp.call_device(x0, x1, dtd)
    out, launches[label], _ = run_counted(
        lambda: interp.call_device(x0, x1, dtd))
    outs[label] = out.cpu().numpy()
  psnr = psnr_db(outs['graphs'], outs['eager'])
  if not psnr >= GRAPH_PSNR_DB or any(
      v != SHARDED_PATCH_LAUNCHES for v in launches.values()):
    failures.append(f'sharded patches with graphs {psnr:.2f} dB vs eager, '
                    f'launches {launches}')
  ms = {'graphs': [], 'eager': []}
  for label in ('graphs', 'eager', 'eager', 'graphs'):
    ms[label].append(measure.time_ms(
        lambda: interps[label].call_device(x0, x1, dtd), iters=3,
        queued=False))
  print(f'graphs: sharded patches {mesh!r} (1080p pair, 2x2 patches): '
        f'{mean(ms["graphs"]):.3f} ms a pair with graphs, '
        f'{mean(ms["eager"]):.3f} eager (turns g/e/e/g: {ms}); with graphs '
        f'vs eager {psnr:.2f} dB; launches {launches["graphs"]}; on {card}')
  report = {'patches': {'ms': ms, 'psnr': psnr, 'launches': launches}}
  del interps
  release_memory()
  report['rows'] = graph_rows(model, options, x0, x1, dtd, card, failures)
  return report


def graph_rows(model, options, x0, x1, dtd, card, failures):
  """The row-sharded 1080p bf16 pair on [cuda:0] * 2 and * 4 as one
  captured program against its eager path and one device: >= 50 dB
  against one device, max-abs against eager, the predicted launches
  through the replay, no host sync inside a replayed call
  (torch.cuda.set_sync_debug_mode('error')), and ms a pair with and
  without graphs in turns. A mesh of several cards runs eagerly (its
  shards launch onto several devices' streams): check_spatial covers it
  where more than one GPU is visible."""
  one = Interpolator(model, options, align=64, device='cuda')
  want = one.call_device(x0, x1, dtd).cpu().numpy()
  del one
  release_memory()
  report = {}
  for n in (2, SHARDS):
    mesh = parallel_mesh.Mesh(['cuda:0'] * n)
    interps = {label: sharded.SpatialShardedInterpolator(
        model, options, mesh, align=64, graphs=label == 'graphs')
               for label in ('graphs', 'eager')}
    torch.cuda.synchronize()
    start = time.perf_counter()
    interps['graphs'].call_device(x0, x1, dtd)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - start
    program = interps['graphs'].program
    capture = next(iter(program.captures.values()))
    # The replayed call alone under the sync check: torch.cuda.synchronize
    # itself counts as a sync there.
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
      out = interps['graphs'].call_device(x0, x1, dtd)
      synced = None
    except RuntimeError as e:  # a host sync inside the replayed call
      out, synced = None, str(e)
    finally:
      torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    eager_out = interps['eager'].call_device(x0, x1, dtd)
    if out is None:
      failures.append(f'graph rows {mesh!r}: a replayed call synced: '
                      f'{synced}')
      out = interps['graphs'].call_device(x0, x1, dtd)
    max_abs = float((out - eager_out).abs().max())
    psnr = psnr_db(out.cpu().numpy(), want)
    if not psnr >= SPATIAL_PSNR_DB or launches != SPATIAL_LAUNCHES[n] or (
        capture.launches != SPATIAL_LAUNCHES[n]):
      failures.append(f'graph rows {mesh!r}: {psnr:.2f} dB vs one device, '
                      f'launches {launches}, recorded {capture.launches}')
    ms = {'graphs': [], 'eager': []}
    for label in ('graphs', 'eager', 'eager', 'graphs'):
      ms[label].append(measure.time_ms(
          lambda: interps[label].call_device(x0, x1, dtd), iters=3,
          queued=False))
    report[repr(mesh)] = {
        'psnr': psnr, 'max_abs_vs_eager': max_abs, 'launches': launches,
        'host_sync': synced, 'ms': ms, 'first_call_s': first_s,
        'capture_s': capture.capture_seconds,
        'pool_bytes': program.pool_bytes}
    print(f'graphs: row-sharded pair {mesh!r} (1080p, released config, bf16 '
          f'policy) as one program: {psnr:.2f} dB vs one device (bound '
          f'{SPATIAL_PSNR_DB}), max-abs vs its eager path {max_abs:.1e}; '
          f'launches a replay {launches}; host syncs in a replayed call '
          f'{"none" if synced is None else synced}; '
          f'{mean(ms["graphs"]):.3f} ms a pair with graphs, '
          f'{mean(ms["eager"]):.3f} eager (turns g/e/e/g: {ms}); first call '
          f'{first_s:.2f} s, capture {capture.capture_seconds:.3f} s, pool '
          f'{program.pool_bytes / 2**30:.2f} GiB; on {card}')
    del interps, program, capture, out, eager_out
    release_memory()
  return report


def check_graphs(mat_path, card, failures):
  """The graph phase: each captured entry point against graphs=False."""
  report = {'pair': graph_pair(card, failures)}
  release_memory()
  report['mixed'] = graph_mixed(card, failures)
  release_memory()
  report['tree'] = graph_tree(card, failures)
  release_memory()
  l1 = configs.get_experiment('film_net-L1')
  report['film_net-L1'] = graph_step(
      'film_net-L1', l1, losses_lib.training_losses(['l1']), 0, card,
      failures)
  style = configs.get_experiment('film_net-Style', mat_path)
  report['film_net-Style'] = graph_step(
      'film_net-Style', style, losses_lib.training_losses(
          list(style.training_losses.names),
          loss_weight_schedules=list(style.training_losses.weight_schedules),
          vgg_model_file=style.vgg_model_file), STYLE_STEP, card, failures)
  release_memory()
  report['summary_step'] = graph_summary_step(card, failures)
  release_memory()
  report['determinism'] = check_determinism(mat_path, card, failures)
  release_memory()
  report['sharded'] = graph_sharded(card, failures)
  release_memory()
  return report


def main() -> int:
  parser = argparse.ArgumentParser(description='GPU smoke test of the port.')
  parser.add_argument('--out', default=None,
                      help='Directory for the nvcc report and a JSON of '
                      'every measurement (optional).')
  # One rank of the data-parallel phase, which this script starts itself.
  for flag in ('--ddp_rank', '--ddp_world'):
    parser.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
  for flag in ('--ddp_url', '--ddp_out'):
    parser.add_argument(flag, default=None, help=argparse.SUPPRESS)
  parser.add_argument('--kernels_only', action='store_true',
                      help='Build and check the kernels against their plain '
                      'versions, then stop (no result line).')
  args = parser.parse_args()
  if args.ddp_rank is not None:
    return ddp_rank_main(args)
  failures = []

  # Phase 1: the card.
  card = device_line()
  print(card)
  kind = torch.cuda.get_device_name(0)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False

  # Phase 2: build.
  start = time.perf_counter()
  _kernels.library()
  print(f'build: {time.perf_counter() - start:.1f} s '
        f'(nvcc {_kernels.BUILD_INFO["seconds"]:.1f} s, sm_90a, '
        f'{_kernels.BUILD_INFO["path"]})')

  # Phase 3: each kernel against its plain version at main-path shapes.
  # The warp has two routes: 16-byte channel vectors where C allows them
  # (the flow estimator's C = 64 ... 960) and runs of flat (pixel, channel)
  # elements where it does not (the train step's fusion warps, C = 67 ...
  # 963); each is checked, the run route also at the train step's two
  # finest fusion warps.
  rng = np.random.RandomState(0)
  checks = {
      'warp': [check_warp(rng, 1088, 1920, 67, torch.bfloat16,
                          WARP_BF16_BOUND),
               check_warp(rng, 1088, 1920, 64, torch.bfloat16,
                          WARP_BF16_BOUND),
               check_warp(rng, 136, 240, 960, torch.bfloat16,
                          WARP_BF16_BOUND),
               check_warp(rng, 544, 960, 195, torch.float32,
                          WARP_F32_BOUND),
               check_warp(rng, 256, 256, 67, torch.float32,
                          WARP_F32_BOUND, batch=TRAIN_BATCH),
               check_warp(rng, 128, 128, 195, torch.float32,
                          WARP_F32_BOUND, batch=TRAIN_BATCH)],
      'conv3x3_c64': [], 'conv3x3_wide': [],
  }
  # The conv at every distinct serving site shape in bf16 (timed), and at
  # four of them in exact f32 (TF32 off).
  for h, w, cin, cout, pool in ((1088, 1920, 64, 64, True),
                                (544, 960, 128, 128, True),
                                (272, 480, 128, 256, False),
                                (272, 480, 256, 256, True),
                                (136, 240, 256, 512, False),
                                (136, 240, 512, 512, False)):
    name = 'conv3x3_c64' if cin == cout == 64 else 'conv3x3_wide'
    checks[name].append(check_conv(rng, h, w, cin, cout, pool,
                                   torch.bfloat16, CONV_BF16_BOUND))
    if (h, cin, cout) in ((1088, 64, 64), (544, 128, 128), (272, 128, 256),
                          (136, 512, 512)):
      checks[name].append(check_conv(rng, h, w, cin, cout, pool,
                                     torch.float32, CONV_F32_BOUND))
  # The train step's conv shapes (f32, batch 8 of 256x256): TF32 allowed,
  # as PyTorch's default has it, and TF32 off.
  for h, cin, cout, pool in ((256, 64, 64, True), (32, 256, 512, False),
                             (16, 512, 512, False)):
    name = 'conv3x3_c64' if cin == cout == 64 else 'conv3x3_wide'
    for tf32, bound in ((True, CONV_TF32_BOUND), (False, CONV_F32_BOUND)):
      checks[name].append(check_conv(rng, h, h, cin, cout, pool,
                                     torch.float32, bound, batch=TRAIN_BATCH,
                                     tf32=tf32))
  # The site shapes of a UHD pair in f32 (2176x3840 after padding), as the
  # CLI serves a release: TF32 allowed, the TF32 route at every site, timed.
  for h, w, cin, cout, pool in ((2176, 3840, 64, 64, True),
                                (1088, 1920, 128, 128, True),
                                (544, 960, 128, 256, False),
                                (544, 960, 256, 256, True),
                                (272, 480, 256, 512, False),
                                (272, 480, 512, 512, False)):
    name = 'conv3x3_c64' if cin == cout == 64 else 'conv3x3_wide'
    checks[name].append(check_conv(rng, h, w, cin, cout, pool,
                                   torch.float32, CONV_TF32_BOUND, tf32=True))
  # Edges the main path also reaches: odd extents (the 17x30 coarsest
  # level, 34x60 next to it), batches (patch tiling), both warp paths in f32;
  # the exact route splits K at 17x30 and at the train step's 8x8x8 (a
  # second pass sums the parts).
  checks['warp'].append(check_warp(rng, 17, 30, 195, torch.float32,
                                   WARP_F32_BOUND, batch=2, timed=False))
  checks['warp'].append(check_warp(rng, 17, 30, 192, torch.float32,
                                   WARP_F32_BOUND, batch=2, timed=False))
  checks['conv3x3_c64'].append(check_conv(
      rng, 17, 30, 64, 64, False, torch.bfloat16, CONV_BF16_BOUND, batch=2,
      timed=False))
  checks['conv3x3_wide'].append(check_conv(
      rng, 34, 60, 128, 128, True, torch.float32, CONV_F32_BOUND, batch=2,
      timed=False))
  checks['conv3x3_wide'].append(check_conv(
      rng, 8, 8, 512, 512, False, torch.float32, CONV_F32_BOUND,
      batch=TRAIN_BATCH, timed=False))
  for h, w, c in ((17, 30, 64), (34, 60, 128)):
    name = 'conv3x3_c64' if c == 64 else 'conv3x3_wide'
    for dtype, bound, tf32 in ((torch.bfloat16, CONV_BF16_BOUND, False),
                               (torch.float32, CONV_TF32_BOUND, True),
                               (torch.float32, CONV_F32_BOUND, False)):
      checks[name].append(check_conv(rng, h, w, c, c, True, dtype, bound,
                                     batch=2, timed=False, tf32=tf32))
  # The training backward's kernels: the warp's derivative planes (B4) and
  # the splat (B5/B6), at shapes of the film_net-L1 train step (f32, batch
  # 8 of 256x256 crops: the two finest fusion warps, a middle and a coarse
  # flow-estimator warp) and at 1080p in bf16, each with four flows; timed
  # with the seam flow, and the splat also with the oob flow at the finest
  # fusion warp, where the frame's edge tiles take long source lists.
  checks['warp_planes'], checks['splat'] = [], []
  for b, h, w, c, dtype in ((8, 256, 256, 67, torch.float32),
                            (8, 128, 128, 195, torch.float32),
                            (8, 128, 128, 192, torch.float32),
                            (8, 32, 32, 960, torch.float32),
                            (1, 1088, 1920, 64, torch.bfloat16),
                            (1, 1088, 1920, 67, torch.bfloat16)):
    f32 = dtype == torch.float32
    for flow_kind in ('seam', 'large', 'oob', 'integer'):
      timed = flow_kind == 'seam'
      checks['warp_planes'].append(check_planes(
          rng, b, h, w, c, dtype,
          PLANES_F32_BOUND if f32 else PLANES_BF16_BOUND, flow_kind, timed))
      checks['splat'].append(check_splat(
          rng, b, h, w, c, dtype,
          SPLAT_F32_BOUND if f32 else SPLAT_BF16_BOUND, flow_kind,
          timed or (flow_kind == 'oob' and (h, c) == (256, 67))))
  # The warp's row mode (B1-rows) at the finest fusion and flow warps of
  # the row-sharded 1080p pair and at an f32 fusion level, timed on the
  # branch each mesh of the serving phase takes at the finest level.
  checks['warp_rows'] = []
  for h, w, c, dtype, bound in ((1088, 1920, 67, torch.bfloat16,
                                 WARP_BF16_BOUND),
                                (1088, 1920, 64, torch.bfloat16,
                                 WARP_BF16_BOUND),
                                (544, 960, 195, torch.float32,
                                 WARP_F32_BOUND)):
    checks['warp_rows'].extend(check_warp_rows(
        rng, h, w, c, dtype, bound, ((4, 'seam'), (2, 'far'))))
  # The warp's slice mode (B1-slice) at the fusion's level-0 slices of a
  # 1080p pair (each frame's features at 0 and 64, vector route; its image
  # at 128 and 131, run route; timed, their sum a level-0 assembly's
  # warps), and in f32 at the coarsest level's widths.
  checks['warp_slice'] = [
      check_warp_into(rng, 1088, 1920, c, 144, channel, torch.bfloat16,
                      WARP_BF16_BOUND)
      for c, channel in ((64, 0), (64, 64), (3, 128), (3, 131))]
  checks['warp_slice'] += [
      check_warp_into(rng, 17, 30, c, 1936, channel, torch.float32,
                      WARP_F32_BOUND, timed=False)
      for c, channel in ((960, 960), (3, 1923))]
  # The decoder's upsampling kernel at the three sites of a 1080p bf16
  # midpoint (timed), the finest site of a UHD f32 pair on the TF32 route
  # (timed), and ragged edges at batch 2 in both dtypes.
  checks['upconv2x2'] = [
      check_upconv(rng, 1, h, w, cin, cout, torch.bfloat16)
      for h, w, cin, cout in ((544, 960, 128, 64), (272, 480, 256, 128),
                              (136, 240, 512, 256))]
  checks['upconv2x2'].append(check_upconv(rng, 1, 1088, 1920, 128, 64,
                                          torch.float32))
  checks['upconv2x2'] += [
      check_upconv(rng, 2, 37, 45, 128, 128, dtype, timed=False)
      for dtype in (torch.bfloat16, torch.float32)]
  # The flow estimators' and the decoder's 3x3 conv kernel at every
  # distinct site of a 1080p bf16 midpoint and of a UHD one in TF32 (timed;
  # TF32 against exact f32), on UHD slices in TF32 against f64 on rounded
  # operands, one slice for each tile plan the UHD sites take, and at
  # ragged edges with K tails of 48 and 16 channels in both dtypes.
  checks['conv3x3_pieces'] = [
      check_pieces(rng, 1, h, w, channels, cout, torch.bfloat16)
      for h, w, channels, cout in PIECES_SITES]
  checks['conv3x3_pieces'] += [
      check_pieces(rng, 1, h, w, channels, cout, torch.float32,
                   rounded=False)
      for h, w, channels, cout in PIECES_SITES_UHD]
  checks['conv3x3_pieces'] += [
      check_pieces(rng, 1, h, w, channels, cout, torch.float32, timed=False)
      for h, w, channels, cout in PIECES_SLICES_TF32]
  checks['conv3x3_pieces'] += [
      check_pieces(rng, n, h, w, channels, cout, dtype, timed=False)
      for n, h, w, channels, cout in ((2, 37, 45, (112, 16), 32),
                                      (2, 37, 45, (144, 64), 64),
                                      (3, 9, 70, (48,), 64))
      for dtype in (torch.bfloat16, torch.float32)]
  # The splat's order, bit for bit: both flows, both dtypes, a C of two
  # channel passes, and oob flow on a whole 256x256 frame, whose edge tiles
  # hold more entries than a block sorts in shared memory.
  checks['splat'] += [
      check_splat_order(rng, b, h, w, c, dtype, flow_kind)
      for b, h, w, c, dtype, flow_kind in (
          (2, 64, 96, 67, torch.float32, 'seam'),
          (2, 64, 96, 67, torch.bfloat16, 'oob'),
          (1, 128, 128, 195, torch.float32, 'seam'),
          (1, 256, 256, 67, torch.float32, 'oob'))]
  for name, results in checks.items():
    for r in results:
      flow_kind = f' {r["flow"]} flow' if 'flow' in r else ''
      library = ('none' if r.get('library_ms') is None else
                 f'{r["library_ms"]:.3f} ms')
      print(f'kernel {name} {r["shape"]} {r["dtype"]}{flow_kind}: max_abs_err '
            f'{r["max_abs_err"]:.3e}' +
            (f' rel_err {r["rel_err"]:.3e}' if 'rel_err' in r else '') +
            (f' (rounded operands rel RMS {r["rounded_rel_rms"]:.2e}, bound '
             f'{r["rounded_bound"]:.1e})' if 'rounded_rel_rms' in r else '') +
            (f' (library rel_err {r["library_rel_err"]:.1e})'
             if 'library_rel_err' in r else '') +
            (f' (whole-frame rows max-abs {r["full_err"]:.1e})'
             if 'full_err' in r else '') +
            (f' (sentinels kept {r["sentinels_kept"]}, bit-equal to the '
             f'contiguous warp {r["contiguous_bit_equal"]})'
             if 'sentinels_kept' in r else '') +
            (f' (two launches bit-equal {r["repeat_bit_equal"]})'
             if 'repeat_bit_equal' in r else '') +
            (f' (bit-equal to the ordered reference {r["order_bit_equal"]})'
             if 'order_bit_equal' in r else '') +
            f' (bound {r["bound"]:.1e}) {"ok" if r["ok"] else "FAILED"}' +
            (f'; kernel {r["ms"]:.3f} ms, plain {r["plain_ms"]:.3f} ms, '
             f'library {library}, bound {r["bound_ms"]:.3f} ms '
             f'({r["bound_by"]}), share {r["share"]:.3f}'
             if 'ms' in r else ''))
      if not r['ok']:
        failures.append(f'{name} {r["shape"]} {r["dtype"]}{flow_kind}')
  pieces = checks['conv3x3_pieces']
  for label, sites in (
      ('a 1080p bf16', pieces[:len(PIECES_SITES)]),
      ('a UHD TF32', pieces[len(PIECES_SITES):2 * len(PIECES_SITES)])):
    print(f'kernel conv3x3_pieces, {label} midpoint\'s 50 sites: kernel '
          f'{pieces_midpoint_ms(sites, "ms"):.3f} ms, library '
          f'{pieces_midpoint_ms(sites, "library_ms"):.3f} ms, bound '
          f'{pieces_midpoint_ms(sites, "bound_ms"):.3f} ms (CUDA events; '
          f'{card})')
  # Every tile plan of the UHD TF32 sites is also held to f64 on rounded
  # operands at a slice.
  uhd_plans = {r['plan'] for r in
               pieces[len(PIECES_SITES):2 * len(PIECES_SITES)]}
  rounded_plans = {r['plan'] for r in pieces if 'rounded_rel_rms' in r}
  print(f'kernel conv3x3_pieces tile plans (rows, N tile): UHD TF32 sites '
        f'{sorted(uhd_plans)}, TF32 checks on rounded operands '
        f'{sorted(rounded_plans)}')
  if not uhd_plans <= rounded_plans:
    failures.append(f'conv3x3_pieces: TF32 plans unchecked on rounded '
                    f'operands {sorted(uhd_plans - rounded_plans)}')
  pieces_trace(failures)
  if args.kernels_only:
    if args.out:
      os.makedirs(args.out, exist_ok=True)
      with open(os.path.join(args.out, 'chip_smoke_build.log'), 'w') as f:
        f.write(str(_kernels.BUILD_INFO.get('log', '')))
    print('chip_smoke: kernels only: ' +
          ('FAILED: ' + '; '.join(failures) if failures else 'all passed'))
    return 1 if failures else 0

  # Phase 4: the serving path, three 1080p pair requests.
  options = Options.film_net_released(dtype_policy='bfloat16')
  model = init_params(create_model(options), torch.Generator().manual_seed(0))
  interpolator = Interpolator(model, options, align=64, device='cuda')
  # The same model eagerly: the plain versions replace the kernels only
  # where Python issues the launches, never inside a captured graph.
  eager = Interpolator(model, options, align=64, device='cuda', graphs=False)
  frames = np.random.RandomState(0).rand(2, 1, 1080, 1920, 3).astype(
      np.float32)
  dt = np.full((1,), 0.5, np.float32)
  _kernels.reset_launch_counts()
  outputs, seconds = [], []
  for _ in range(REQUESTS):
    start = time.perf_counter()
    outputs.append(interpolator(frames[0], frames[1], dt))
    seconds.append(time.perf_counter() - start)
  launches = _kernels.launch_counts()

  expected = {k: REQUESTS * v for k, v in PAIR_LAUNCHES.items()}
  if launches != expected:
    failures.append(f'launches {launches} != {expected}')
  out = outputs[0]
  if out.shape != (1, 1080, 1920, 3):
    failures.append(f'output shape {out.shape}')
  if not all(np.isfinite(o).all() for o in outputs):
    failures.append('non-finite output')
  repeat_err = max(float(np.abs(o - out).max()) for o in outputs[1:])
  if repeat_err > REPEAT_BOUND:
    failures.append(f'repeated requests differ by {repeat_err:.3e}')

  x0 = torch.from_numpy(frames[0]).cuda()
  x1 = torch.from_numpy(frames[1]).cuda()
  dtd = torch.from_numpy(dt).cuda()
  # End to end: the host's lag between launches counts, so the card does
  # not queue the loop first.
  device_ms = measure.time_ms(lambda: interpolator.call_device(x0, x1, dtd),
                              iters=3, queued=False)
  with plain_versions():
    _kernels.reset_launch_counts()
    plain_out = eager(frames[0], frames[1], dt)
    plain_launches = sum(_kernels.launch_counts().values())
    plain_device_ms = measure.time_ms(
        lambda: eager.call_device(x0, x1, dtd), iters=3, queued=False)
  if plain_launches:
    failures.append(f'plain forward launched {plain_launches} kernels')
  mse = float(np.mean((out.astype(np.float64) - plain_out)**2))
  psnr = 10.0 * np.log10(1.0 / max(mse, 1e-20))
  if not psnr >= PSNR_BOUND_DB:
    failures.append(f'PSNR kernels vs plain {psnr:.2f} dB < {PSNR_BOUND_DB}')
  request_ms = [1e3 * s for s in seconds]
  print(f'serving path: {REQUESTS} requests of a 1080p pair (released config, '
        f'bf16 policy), request ms {[round(t, 3) for t in request_ms]}, '
        f'{min(request_ms[1:]):.3f} ms/pair after warm-up (numpy in/out), '
        f'{device_ms:.3f} ms/pair on device (plain versions: '
        f'{plain_device_ms:.3f} ms); launches {launches}; repeat max-abs '
        f'{repeat_err:.1e}; PSNR kernels vs plain {psnr:.2f} dB; on {card}')
  bundle_report = check_jax_bundle(model, options, out, frames, dt, card,
                                   failures)
  tf_report = check_tf_release(model, options, out, frames, dt, card,
                               bundle_report, failures)

  # Phase 5: the video slice: the exact uint8 rules, the frame tree by both
  # routes, the tiled tree.
  release_memory()
  uint8_report = check_uint8_rules(failures)
  video_report = check_video(interpolator, eager, card, failures)
  # The serving interpolator lives on through the next phases: its graphs
  # (up to its pool's budget) go back first.
  interpolator.release_graphs()
  release_memory()
  tiled_report = check_tiled_tree(model, options, card, failures)
  release_memory()

  # Phase 6: sharded serving on meshes of the card.
  spatial_report = check_spatial(model, options, frames, dt, out, card,
                                 failures)
  release_memory()
  sharded_report = check_sharded_patches_and_tree(model, options, eager,
                                                  card, failures)
  release_memory()
  spatial_launches = spatial_report[
      repr(parallel_mesh.Mesh(['cuda:0'] * SHARDS))]['launches']

  # Phase 6a: the split-concat convs against the concat form.
  split_report = check_split(model.state_dict(), frames, dt, card, failures)
  del interpolator, eager, model
  release_memory()

  # Phase 7: the training path: film_net-L1, then film_net-Style with
  # VGG-19 at its true widths, by the preset and by a gin file.
  train_report, train_launches = check_training(card, failures)
  with tempfile.TemporaryDirectory() as vgg_dir:
    mat_path = os.path.join(vgg_dir, 'imagenet-vgg-verydeep-19.mat')
    write_vgg_mat(mat_path)
    style_report = check_style(mat_path, card, train_report, failures)
    gin_report = check_gin_loop(mat_path, card, failures)
    # Phase 7a: the captured entry points against the eager ones.
    release_memory()
    graphs_report = check_graphs(mat_path, card, failures)
  release_memory()

  # Phase 8: the eval loop.
  eval_report = check_eval(card, failures)

  # Phase 9: the host's data plane: the native CRC, the dataset builders
  # (read back and evaluated on the card).
  crc_report = check_native_crc(card, failures)
  builders_report = check_builders(card, failures)

  # Phase 10: data-parallel training across processes.
  ddp_report = check_ddp(card, failures)

  # Launches: the serving run's for the forward kernels, the 20-step
  # training run's for the backward ones, the row-sharded pair's over 4
  # shards for the row mode. Times: the serving kernels' bf16 shapes, the
  # backward kernels' every timed shape.
  record = {'kernels': []}
  for name in ('warp', 'warp_planes', 'splat', 'conv3x3_c64', 'conv3x3_wide',
               'warp_rows', 'warp_slice', 'conv3x3_pieces'):
    backward = name in ('warp_planes', 'splat')
    main_launches = (train_launches if backward else spatial_launches
                     if name == 'warp_rows' else launches)
    timed = [r for r in checks[name]
             if 'ms' in r and (backward or r['dtype'] == 'bfloat16')]
    libraries = [r['library_ms'] for r in timed]
    ops_ms = sum(r['bound_ops_ms'] for r in timed)
    bytes_ms = sum(r['bound_bytes_ms'] for r in timed)
    record['kernels'].append({
        'name': name, 'route': 'cuda', 'source': SOURCES[name],
        'replaces': REPLACES[name],
        'launches': main_launches[name],
        'max_abs_err': max(r['max_abs_err'] for r in timed),
        'ms': sum(r['ms'] for r in timed),
        'plain_ms': sum(r['plain_ms'] for r in timed),
        'bound_ms': sum(r['bound_ms'] for r in timed),
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': (None if None in libraries else sum(libraries)),
    })

  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'chip_smoke_build.log'), 'w') as f:
      f.write(str(_kernels.BUILD_INFO.get('log', '')))
    with open(os.path.join(args.out, 'chip_smoke.json'), 'w') as f:
      json.dump({'card': card, 'checks': checks, 'request_ms': request_ms,
                 'device_ms': device_ms, 'plain_device_ms': plain_device_ms,
                 'launches': launches, 'psnr_db': psnr,
                 'repeat_err': repeat_err, 'uint8': uint8_report,
                 'jax_bundle': bundle_report, 'tf_release': tf_report,
                 'video': video_report,
                 'tiled_tree': tiled_report, 'spatial': spatial_report,
                 'sharded': sharded_report, 'training': train_report,
                 'style': style_report, 'gin_loop': gin_report,
                 'eval': eval_report, 'split': split_report,
                 'native_crc': crc_report, 'builders': builders_report,
                 'ddp': ddp_report, 'graphs': graphs_report,
                 'failures': failures}, f, indent=1,
                default=str)

  if failures:
    print('chip_smoke: FAILED: ' + '; '.join(failures), file=sys.stderr)
    return 1
  print(json.dumps({'native_crc': {
      'route': 'c', 'source': 'frame_interpolation_tpu_torch/native/fi_native.c',
      'replaces': 'frame_interpolation_tpu/native/_fi_native.c',
      'mb_s': crc_report['native_mb_s'],
      'python_mb_s': crc_report['python_mb_s']}}))
  print(json.dumps(record))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  try:
    sys.exit(main())
  except CheckFailed as e:
    print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
    sys.exit(1)
