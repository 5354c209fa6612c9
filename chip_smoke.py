#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check that it is right.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device — the card's name and power limit, as nvidia-smi reports them;
2. build  — compile the fbank kernel from csrc/fbank.cu (timed); ptxas's
   register/spill report (any spill fails) and the count of tensor-core
   ``HMMA`` instructions in the kernel's SASS (none fails); the frames a
   block computes, as the library reports them; then the conv epilogue
   from csrc/bn_act.cu, its ptxas report (any spill fails);
3. kernel — ``fbank_cuda`` against its plain PyTorch version on the card
   (atol 2e-4, rtol 1e-4) at the listed shapes (int16-scaled audio, a
   silent stretch at the energy floor, 3 whole blocks of frames and one
   frame more among them), a [3, n] batch and a [4, bucket] multichannel
   bucket batch equal to each channel alone, and fused_conv's whole-track
   shape (18,432 frames for 150 s) and the feature cache's 30,000-frame
   bucket (phase 10's path), and at the AST preset's features (128 bins,
   Hann, 20 Hz to Nyquist, the eps floor) a track, a silent stretch, the
   clips cell's [6, 1,108,080] bucket batch (each row equal alone) and one
   such row (timed); on a tone, where the mel bins span
   ~17 nats and no fp32 path meets that tolerance, the kernel within 1.5x
   JAX ``fbank_jit``'s own error of float64 truth (computed on the card);
   the kernel's, the plain version's and one cuBLAS matmul's times at the
   main-path bucket, the whole track and the cache's bucket, beside the
   3xTF32 tensor-core bound (the JSON line's ``bound_ms``, at the bucket)
   and the fp32 CUDA-core one (printed only); then the conv epilogue
   (ops/bn_act_cuda.py) at the sweep's band and tail shapes: in bf16 bit
   for bit the eager chain it replaces, its time beside that chain's and
   its byte bound, in NCHW and in NHWC (channels-last: the bf16 classify
   step's layout); at the band shape in NHWC also its padded form (a zero
   row above the result, the next band conv's input, in the same launch)
   bit for bit ``F.pad`` of the unpadded form, timed beside the unpadded
   kernel followed by ``F.pad``; in float32 ``layers.conv_bn_act`` (the
   bias in the library's conv) bit for bit the composed chain;
4. main path — full-width ``resnet_base`` ResNetBigger (numpy-seeded
   weights in a ``.ckpt.npz``) segments ~150 s of synthetic int16 audio
   through the port's CLI on ``cuda``; the kernel must launch once per
   bucket; the probabilities must be finite, in [0, 1], and agree with the
   port on the CPU; the TextGrid must read back as the smoothing of those
   probabilities; shared-stem and naive windows must agree within 1e-5;
   then the e2e time (best of 3 warm ``segment_file`` calls) and, from a
   torch.profiler trace of one more call, where its device time goes;
5. fused_conv — the same model and audio through the CLI with ``--mode
   fused_conv``: one kernel launch for the file; finite probabilities in
   [0, 1]; the card within 1e-4 of the port on the CPU (5 s clip); the
   blocked track within 1e-5 of the whole track on the card; the TextGrid
   reads back; e2e best of 3, peak device memory, the device breakdown;
   then a one-hour track: its peak memory with the blocks dispatched in
   groups, and the groups within 1e-5 of one batch of every block;
6. streaming — the 150 s file replayed through the port's ``cli/serve.py``
   (250 ms feeds): the saved probabilities equal the offline ones bit for
   bit, the events equal the offline smoothing, the kernel launches once
   per bucket plus the warm-up bucket; the time of the feed that
   completes a bucket;
7. multichannel — 4 channels of 150 s (one 777 samples shorter) through
   ``ShardedPipeline``: each row within 1e-5 of the single-channel
   pipeline, one launch per bucket batch, ``ShardedStreamingSession``
   equal to the offline batch bit for bit, ``serve --channels 4`` over
   stdin (20 s, a subprocess) emitting every channel's offline events;
   audio-seconds per wall-second, peak memory, the device breakdown; the
   peak memory of 9 channels of 20 s; then several shards in one process
   (``ShardedPipeline(devices=...)``): (a) two shards of card 0
   (``cuda:0,cuda:0``), float32 and bfloat16 rows bit-equal to one
   shard's, one fbank launch per shard per bucket batch, the streaming
   session equal to the one-shard batch, ``serve --channels 4 --device
   cuda:0,cuda:0`` (in this process) giving one shard's events, and one
   bucket batch's host syncs under ``torch.cuda.set_sync_debug_mode`` (its
   body must have none); (b) with more than one card visible, the same
   over every card (``mesh.local_devices('cuda')``) with rows within 1e-6,
   the card count and the aggregate rate beside one card's; with one card
   it prints that (b) did not run;
8. corpus sweep — a synthetic ICSI-layout corpus written under
   build/chip_smoke (preambles and four meetings with laugh, speech,
   noise and invalid segments at known times; Bmr021 4 x 600 s, one
   channel 777 samples short, Bns001 3 x 300 s, Bmr013 2 x 30 s and
   Bro012 4 x 200 s in shorten SPHERE, ICSI's own encoding, Bro012's
   channels encoded in parallel processes and kept in
   build/chip_smoke/cache; ~70 min of int16 audio) through ``cli/sweep.main``
   ``--split all --analyse`` on ``cuda`` at the 29 x 3 grid: 87 TextGrids
   per channel, each equal to the smoothing of an in-process
   ``ShardedPipeline.probs_for_meeting``; one launch per bucket batch (and
   per warmed channel count); 87 sum-stats rows with finite precision,
   read back alike by ``analyse``; no pandas or lxml loaded; every
   shorten channel decoded by the native C++ decoder (runtime/native.py),
   none by the numpy one.  Then the
   sweep with ``--transfer_codec packed`` (the same TextGrids; on two
   packed-decoded [4, bucket] batches, Bmr021's first and one of
   close-talk-like audio that must pack to <= 0.9 of raw, the
   probabilities bit-equal to raw and the kernel held against its plain
   version; the wire ratio, the native and numpy pack times beside the
   raw upload's, the decode time) and with ``--mode fused_conv`` (one
   launch per meeting); the swept hours, audio-s per wall-s end to end and
   inference only (best of 2), the shorten decode's and the TextGrid
   writes' shares of the wall, the rate expected on an all-shorten corpus
   from the measured decode rate, the sweep of Bro012 alone (the rate on
   ICSI's encoding), peak memory and one meeting's device breakdown;
9. training — full-width ``resnet_base`` under strict fp32 (Adam lr 1e-3,
   clip 1.0) on 100-frame windows of the kernel's features of phase 4's
   audio with numpy-seeded labels: (a) one step at dropout 0 against the
   port on the CPU from the same weights (loss 1e-5, gradients 1e-4 of
   max(1, the leaf's max |g|)), and the card's Adam update within 1e-6 of
   the CPU's Adam applied to the card's gradients; (b) 20 steps at dropout
   0.5 on one batch lower the loss; (c) ``TrainLoop`` checkpoints, stops at
   a step boundary on SIGTERM and resumes: counters restored, parameters
   within 1e-4 of an uninterrupted run; (d) the trained checkpoint through
   ``cli/segment_laughter`` on the card: finite probabilities, TextGrids
   equal to the smoothing of ``LaughterPipeline`` with those weights;
   (e) train steps per second at B = 32 and 1024 (best of 3 x 50 and 3 x
   20 steps, CUDA events), peak memory, and the device time of one step by region
   (forward, backward, optimizer) and kind (convs, the rest); at B = 32
   ``cli/train``'s cuDNN flags (deterministic, no autotuning) in turns with
   the flags as they are, the mode's cost at the preset's batch;
10. training from a corpus — phase 8's corpus (Bro012 in train, Bmr021
   and Bns001 in dev, Bmr013 in test) through the port's three training
   CLIs on the card: (a) ``cli/create_data_df`` in structured mode at 100
   laugh and 100 non-laugh samples a laugh (a train split of 14,800 rows):
   every split's non-laugh rows the 70/10/20 silence/noise/speech mix and
   its meetings its own; (b) ``cli/compute_features --device cuda`` over
   every split: one fbank launch per 30,000-frame bucket of every track, a
   cached track (two buckets, the last partial) within TOL of the plain
   featurizer on the same PCM on the card, and a second run featurizes
   nothing; (c) ``cli/train --config resnet_base`` for one epoch of every
   other row of the train table (7,400 rows, 232 steps of 32; the preset logs every 900 steps, so the epoch has no log
   point: tests/test_torch_train_resident.py runs the CLI's log point)
   streamed (``--device_cache off``), resident (``on``) and resident with
   ``--steps_per_dispatch 4``, under the cuDNN deterministic mode
   ``cli/train`` sets itself on the card (the phase sets nothing): the
   three checkpoints within 1e-6, the resident runs naming their row
   count; (d) the streamed run stopped by SIGTERM before step 117 and
   resumed through the CLI (``skip_assembly``) within 1e-6 of the
   uninterrupted one; (e)
   the trained checkpoint through ``cli/segment_laughter``, its TextGrid
   equal to the smoothing of ``LaughterPipeline`` with those weights; (f)
   train steps per second streamed and resident at B = 32 and 1024 (host
   clock, best of 3), each with the device's busy share and region
   breakdown (torch.profiler), the host time to assemble one streamed
   batch, the resident split's bytes, build and upload time, and peak
   memory;
11. bf16 serving — the card's default precision: phase 4's audio and
   model through ``cli/segment_laughter`` with no ``--precision`` (one
   launch per bucket, the TextGrid equal to the smoothing), the bf16
   pipeline within 0.05 of phase 4's float32 probabilities, within 2e-2 of
   the port's bf16 on the CPU (5 s clip), shared stem within 2e-2 of naive
   windows; fused_conv, serve replay (bit-equal to the bf16 offline
   probabilities) and 4 x 150 s multichannel (rows within 0.05 of phase 7's,
   ``ShardedStreamingSession`` bit-equal to the batch) in bf16; x realtime
   and audio-s per wall-s beside the float32 figures, peak memory, the
   device breakdown by kind; one bf16 sweep of phase 8's corpus, its
   TextGrids equal to the smoothing of the in-process bf16
   ``ShardedPipeline``, its launches those of phase 8's float32 sweep;
12. bf16 training — ``Trainer(compute_dtype='bfloat16')`` at full width:
   one step at dropout 0 against the port's bf16 step on the CPU (loss
   rtol 2e-2; parameters rtol 5e-2, atol 5e-3: JAX's mixed-precision
   tolerances), masters, Adam moments and BN buffers float32; the card's
   bf16 gradients against the CPU's on three batches (within 2e-2 of
   max(1, max|g|), each weight's at cosine >= 0.85 and closer than the
   CPU's float32 gradients), the card's x 0.9 read beside them; 20 steps at
   dropout 0.5 lower the loss; steps per second at B = 32 and 1024 beside
   phase 9's float32, peak memory, device time by region; ``cli/train
   --precision bfloat16 --device_cache on`` for one epoch on phase 10's
   tables, its checkpoint float32 and through ``cli/segment_laughter``;
13. export — ``cli/export_model --what windows`` in float32 and bf16
   (symbolic batch), each loaded and called at B = 1, 37 and 6,144 (f32
   within 1e-6 of the live model, bf16 within 2e-2 of the live bf16
   copy); ``--what e2e --wave_dtype int16`` at chunk and bucket 6,144,
   loaded in a fresh process that imports only ``export`` and
   ``host_prep`` and run per bucket over phase 4's audio through
   ``bucket_inputs``: the fbank kernel launched once a bucket inside the
   artifact, the probabilities within 1e-6 of (printed: equal to)
   ``LaughterPipeline.probs_for_waveform``, its time a bucket beside the
   live pipeline's; ``cli/convert_checkpoint`` .ckpt.npz -> .pth.tar ->
   .ckpt.npz with equal tensors;
14. multi-process — full-width ``resnet_base`` over ``torch.distributed``,
   every group joined through a file under build/chip_smoke, its processes
   (``chip_smoke.py --worker``) killed after 300 s: (a) one process in an
   NCCL group of one: ``DataParallelTrainer``'s step at B = 64 equals
   ``Trainer``'s (1e-6), both steps' rates between CUDA events, one NCCL
   all_reduce of the flattened gradients; (b) two processes sharing the
   card over Gloo, global B = 64 of phase 10's features, dropout 0.5: three
   steps, each from the two-process state, against one process's step
   (loss 1e-5; gradients within 1e-4 of max(1, the leaf's max |g|) of
   float64 truth, or no further than 1.5x one process's float32 step, which
   on these features is ~1e-3 from truth; BN running statistics 1e-6; the
   parameters 1e-6 from one process's Adam on the two-process gradients
   from the same state); the sharded
   resident split's gather step equal to the streamed local-rows step
   (1e-6); the step's, the Gloo all_reduce's, the gather's and a vote's
   times; SIGTERM to rank 1 mid-epoch stops both at the next vote, and the
   resume through ``sync_resume`` (rank 1 without a checkpoint) ends where
   the uninterrupted epoch ends (1e-6); two processes on one card over
   NCCL refuse, naming ``--cpu_collectives gloo``; (c) ``cli/sweep`` of
   phase 8's Bmr021 (4 x 600 s) on two processes: TextGrids byte-equal
   and analyse rows equal to one process's, each rank's fbank launches
   those of its 2 channels' bucket batches plus a warm-up, audio-s per
   wall-s beside one process's; (d) ``cli/train --data_parallel
   --device_cache on`` on two processes over a one-batch epoch (64 rows of
   phase 10's tables; the coordinator featurizes into a fresh cache first,
   rank 1 after the barrier): its checkpoint took one process's step (the
   rule of (b), from the checkpoints' Adam moments);
15. retired: it ran the port's bench twin, which went once ``benchmark/``
   measured the port (``python3 benchmark/run.py --workload <cell>``);
16. parity, demos and tools — (a) the drill's inputs
   (tests/fixtures/parity_inputs.py: the synthetic transcripts, Btr001's two
   channels of 2.5 s, a full-width ``resnet_base`` checkpoint from numpy
   seeds) through ``cli/parity.main --device cuda`` against the goldens the
   JAX package's parity CLI wrote on the CPU (tests/fixtures/
   parity_goldens/): all five checks pass, none skipped, probabilities
   within 1e-4 (the other limits the CLI's defaults); each check's largest
   difference beside its limit, the smallest margin of a card probability
   to a threshold of the goldens' grid; the fbank kernel launched once a
   file by the features check and once a bucket on every other path of the
   run; (b) ``examples/demo_torch.py`` and ``examples/streaming_demo_torch.py
   --device cuda`` in processes of their own, started first: rc 0, the
   demo's TextGrids and evaluation table, its kernel launches (one a track
   featurized, one a bucket classified), the streaming demo's bit-equality
   line; (c) ``cli/laughs_to_wav --concat`` on phase 4's TextGrid and
   audio: each piece the int16 of its interval, the gaps silent; (d)
   ``cli/probe_audio_loading`` on a shorten channel of phase 8's corpus
   names the native decoder;
17. AST clips sweep — ``cli/sweep.main --config ast_audioset --random_init
   --device cuda:0 --analyse`` (the AudioSet AST at its published widths,
   seeded weights, bf16) over a meeting of 2 x 130 s: rc 0, 87 TextGrids a
   channel, the fbank kernel launched once a bucket batch of 6,000 frames
   (3) and once for the warm-up, 60 clips a channel each launch;
18. the card, one JSON line of the kernels (the fbank kernel at the main
   path's bucket and its time on the clips bucket row; ``launches`` counted
   on phase 8's sweep, the launches of every path, the bf16 paths', the e2e
   artifact's, each rank's of phase 14, phase 16's paths and phase 17's AST sweep included, beside them)
   and of the conv epilogue (``launches`` counted on phase 11's bf16 sweep,
   beside the launches of each path counted: phases 4-8, 11 and 13, the
   train steps of phases 9 and 12, and phase 16's parity run), then the
   result line.  Each path's epilogue launches must equal the convs its
   classify steps run (``convs_per_bucket``): 0 on fused_conv and in a
   train step; those that write zero rows around their result
   (``launches_padded``) the band convs whose result the next band conv
   reads (``padded_per_bucket``).

``python3 chip_smoke.py --through 7`` runs phases 1-7 alone and prints
no result line: phase 7 (b) on a host of several cards, where phases 8
on count launches for one card.

Phases 4-10 and 14 compare float32 numbers and pass ``precision='float32'`` (or
``--precision float32``) explicitly: the card's default is bf16.  Phase 16's
parity CLI runs in float32 on every device.

The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
try:  # the port's measurement helpers; outside a checkout, main() says what is missing
    from laughter_detection_icsi_tpu_torch.utils.timing import cuda_ms, device_breakdown, kernel_kind
except ImportError:
    cuda_ms = device_breakdown = kernel_kind = None
TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_fbank_pallas.py's feature tolerance
#: JAX ``fbank_jit``'s largest error against float64 truth on ``tone()``
#: (tests/test_torch_fbank_tf32.py measures it on the CPU): the kernel is
#: held to 1.5x it there, where no fp32 path meets TOL.
JAX_TONE_ERR = 1.8456e-3
SECONDS = 150  # main-path audio: three 6144-frame buckets, the last partial
DEVICE = "cuda"  # phase 9's device (a rehearsal on the CPU sets "cpu")
TRAIN_SIZES = (32, 1024)  # phase 9's timed batches: resnet_base's preset, and a large one
#: Phase 12 (a): the card's bf16 gradients against the CPU's, at full width,
#: B = 32, as a share of max(1, max|g|) and as the least cosine of a weight's
#: gradient (H100 80GB HBM3, 700 W: 3.7e-3 to 7.8e-3 and 0.913 to 0.958 on
#: its three batches; zero gradients read max|g| >= 0.11 and cosine 0).  The
#: CPU's float32 gradients read 9.0e-3 to 1.25e-2 and 0.733 to 0.856, so
#: each batch's least cosine must also beat theirs: the card runs the bf16
#: chain.  PERF.md section 6 records the readings.
BF16_GRAD_TOL, BF16_GRAD_COS = 2e-2, 0.85

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# float32 outside the tensor cores, TF32 on the tensor cores (half the
# sheets' with-sparsity figure), and memory bandwidth.
PEAKS = (  # (name fragment, FP32 FLOP/s, TF32 FLOP/s, bytes/s); first match wins
    ("H100 PCIe", 51.2e12, 378e12, 2.0e12),
    ("H100 NVL", 60.0e12, 417.5e12, 3.9e12),
    ("H200", 67.0e12, 495e12, 4.8e12),
    ("H100", 67.0e12, 495e12, 3.35e12),
)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def convs_per_bucket(model, settings, shared: bool) -> int:
    """The convs one ``inference.classify_bucket`` call runs, each followed
    by one launch of the conv epilogue on the card in eval mode.  A naive
    window batch runs every conv of the model a chunk.  The shared stem
    runs stage 1's (and, where ``supports_track2``, stage 2's) convs once
    over the whole track, and a chunk runs those convs again on its two
    edge bands beside the later stages' convs."""
    from torch import nn

    from laughter_detection_icsi_tpu_torch.models import shared_stem

    convs = lambda parts: sum(isinstance(m, nn.Conv2d) for p in parts for m in p.modules())
    n_chunks = -(-settings.bucket_frames // settings.chunk)
    if not shared:
        return n_chunks * convs([model])
    stages = model.stages()
    k = 2 if shared_stem.supports_track2(settings.window) else 1
    track = convs([model.conv1, *stages[:k]])
    return track + n_chunks * (2 * track + convs(stages[k:]))


def padded_per_bucket(model, settings, shared: bool) -> int:
    """Of ``convs_per_bucket``'s launches, those that write their result
    with a zero row beside it: in each chunk of the shared stem, at both
    window edges, every band conv whose result the next band conv reads
    (stage 1's band: the stem conv and each block's two convs but the
    last; stage 2's, where ``supports_track2``: each block's two but the
    last).  None elsewhere."""
    from laughter_detection_icsi_tpu_torch.models import shared_stem

    if not shared:
        return 0
    stages = model.stages()
    band = 2 * len(stages[0])
    if shared_stem.supports_track2(settings.window):
        band += 2 * len(stages[1]) - 1
    return -(-settings.bucket_frames // settings.chunk) * 2 * band


class EpilogueCount:
    """The conv epilogue's launches (``ops/bn_act_cuda.launches``) over one
    path's run, held against the launches the run owes: ``with
    EPILOGUES.count(path):`` zeroes the counters and, while it lasts, adds
    ``convs_per_bucket`` (and ``padded_per_bucket``) for each classify step
    (``classify_bucket``, as inference and the sharded pipeline call it).
    On leaving it checks the two are equal, that the NHWC form took a bf16
    path's launches and no other's, and that the padded launches are those
    owed, and keeps the count under ``path``.  A path with no classify step
    (fused_conv, a train step) owes 0."""

    def __init__(self):
        self.by_path = {}
        self.padded_by_path = {}

    def count(self, path: str):
        import contextlib

        from laughter_detection_icsi_tpu_torch import inference
        from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda
        from laughter_detection_icsi_tpu_torch.parallel import sharded_inference

        @contextlib.contextmanager
        def counting():
            owed = [0, 0]
            real = inference.classify_bucket

            def counted(model, feats, valid, settings, use_shared_stem):
                owed[0] += convs_per_bucket(model, settings, use_shared_stem)
                owed[1] += padded_per_bucket(model, settings, use_shared_stem)
                return real(model, feats, valid, settings, use_shared_stem)

            mods = (inference, sharded_inference)
            saved = [m.classify_bucket for m in mods]
            for m in mods:
                m.classify_bucket = counted
            bn_act_cuda.launches = bn_act_cuda.launches_nhwc = bn_act_cuda.launches_padded = 0
            try:
                yield
            finally:
                for m, f in zip(mods, saved):
                    m.classify_bucket = f
            self.check(path, bn_act_cuda.launches, owed[0], bn_act_cuda.launches_nhwc,
                       (bn_act_cuda.launches_padded, owed[1]))

        return counting()

    def check(self, path: str, launches: int, owed: int, nhwc=None, padded=None) -> None:
        """Also, where ``nhwc`` (the launches of the NHWC form) is given:
        a bf16 path's launches (``_bf16``: a bf16 pipeline on the card) are
        all NHWC, any other path's none; where ``padded`` (the launches
        that wrote zero rows, those owed) is given, the two are equal."""
        check(launches == owed, f"{path}: {launches} conv epilogue launches where its classify "
                                f"steps owe {owed}")
        if nhwc is not None:
            want = launches if path.endswith("_bf16") else 0
            check(nhwc == want, f"{path}: {nhwc} of its {launches} conv epilogue launches in "
                                f"NHWC where its precision owes {want}")
        if padded is not None:
            check(padded[0] == padded[1], f"{path}: {padded[0]} of its {launches} conv epilogue "
                                          f"launches wrote zero rows where its band convs owe "
                                          f"{padded[1]}")
            self.padded_by_path[path] = padded[0]
        self.by_path[path] = launches


EPILOGUES = EpilogueCount()


def speechlike(n: int, seed: int) -> np.ndarray:
    """Int16 audio whose frames differ: noise under a slow envelope plus a
    gated frequency sweep."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    env = 0.05 + 0.6 * np.sin(2 * np.pi * 0.7 * t) ** 2
    tone = np.sin(2 * np.pi * (200 + 300 * np.sin(2 * np.pi * 0.3 * t)) * t)
    w = 0.3 * r.standard_normal(n) * env + 0.3 * tone * (np.sin(2 * np.pi * 1.3 * t) > 0)
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


def closetalk(n: int, seed: int) -> np.ndarray:
    """Int16 audio shaped like a close-talk channel: room noise near
    silence, and 40% of the time voiced bursts (a 110-170 Hz pitch with
    harmonics falling as 1/k^2) at a syllable rate: spectrally tilted, so
    its first-order deltas are several bits narrower than its samples, as
    speech's are (``speechlike``'s noise packs larger than raw)."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    phase = 2 * np.pi * np.cumsum(140 + 30 * np.sin(2 * np.pi * 0.4 * t)) / 16000
    voiced = sum(np.sin(k * phase) / k**2 for k in range(1, 9))
    talking = np.sin(2 * np.pi * 0.1 * t + r.uniform(0, 2 * np.pi)) > 0.3
    syllables = np.sin(2 * np.pi * 3 * t + r.uniform(0, 2 * np.pi)) ** 2
    w = 0.25 * talking * syllables * voiced + 0.001 * r.standard_normal(n)
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


def tone(seed: int = 0) -> np.ndarray:
    """16,000 samples of ``0.3 sin(0.05 n)`` over the first 8,000, then
    silence, plus uniform int16 noise of +-2 LSB, scaled to [-1, 1)
    (tests/test_torch_fbank_tf32.py's tonal input)."""
    n = np.arange(16000)
    pcm = np.where(n < 8000, 0.3 * np.sin(0.05 * n) * 32767, 0.0)
    pcm = np.round(pcm) + np.random.default_rng(seed).integers(-2, 3, 16000)
    return pcm.astype(np.int16).astype(np.float32) / np.float32(32768)


def seeded_state_dict(model, seed: int, head_gain: float = 0.03):
    """Numpy-drawn weights in the JAX package's (params, state) layout,
    carried in through ``state_dict_from_jax``.  ``head_gain`` scales the
    last linear layer so the probabilities spread over (0, 1)."""
    from laughter_detection_icsi_tpu_torch.train.checkpoint import state_dict_from_jax

    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for key, t in model.state_dict().items():
        shape, leaf = tuple(t.shape), key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            state[key] = np.asarray(rng.integers(0, 100), np.int32)
        elif leaf == "running_mean":
            state[key] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif leaf == "running_var":
            state[key] = (1.0 + 0.5 * rng.random(shape)).astype(np.float32)
        elif len(shape) == 1:
            base = 1.0 if leaf == "weight" else 0.0
            params[key] = (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            w = rng.standard_normal(shape) * math.sqrt(2.0 / np.prod(shape[1:]))
            params[key] = (w * (head_gain if key.startswith("linear2") else 1.0)).astype(np.float32)
    return state_dict_from_jax(params, state)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    peak = next((dict(fp32=f, tf32=tf, bytes=b) for frag, f, tf, b in PEAKS if frag in kind),
                None)
    check(peak is not None, f"no published peaks on file for {kind!r}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s); peaks used: "
          f"{peak['fp32'] / 1e12:g} TFLOP/s fp32, {peak['tf32'] / 1e12:g} TFLOP/s TF32 "
          f"tensor cores, {peak['bytes'] / 1e12:g} TB/s")
    return card, kind, peak


def phase_build():
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

    t0 = time.perf_counter()
    lib = fbank_cuda.build()
    fbank_cuda._library()
    seconds = time.perf_counter() - t0
    print(f"built {lib.relative_to(REPO)} in {seconds:.2f} s")
    check(not any(ptxas_spills(lib)), "the fbank kernel spills registers")
    ops = sass_opcodes(lib, "fbank_kernel")
    hmma = sum(op.startswith("HMMA") for op in ops)
    print(f"  SASS: {hmma} HMMA (tensor-core) of {len(ops)} instructions in fbank_kernel "
          f"(dump: {lib.with_suffix('.sass').relative_to(REPO)})")
    check(hmma > 0, "no HMMA instruction in fbank_kernel: the DFT is not on the tensor cores")
    block_frames = fbank_cuda.frames_per_block()
    print(f"  the kernel computes {block_frames} frames a block")

    from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda

    t0 = time.perf_counter()
    lib = bn_act_cuda.build()
    bn_act_cuda._library()
    print(f"built {lib.relative_to(REPO)} in {time.perf_counter() - t0:.2f} s")
    check(not any(ptxas_spills(lib)), "the conv epilogue kernel spills registers")
    return block_frames


def ptxas_spills(lib: Path) -> list:
    """The spill bytes (stores + loads) of each kernel in the nvcc report
    kept beside ``lib``; its register and spill lines are printed."""
    log = lib.with_suffix(".log")
    check(log.is_file(), f"no nvcc report beside {lib.name}")
    spills = []
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills.append(int(m.group(1)) + int(m.group(2)))
    check(spills, "ptxas printed no spill report")
    return spills


def sass_opcodes(lib: Path, function: str) -> list:
    """The opcodes, in order, that ``cuobjdump -sass`` shows in the kernels
    of ``lib`` whose name holds ``function``.  The whole dump is kept beside
    the library as ``.sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    check(CUDA_HOME is not None, "no CUDA toolkit (cuobjdump)")
    sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
    lib.with_suffix(".sass").write_text(sass.stdout)
    ops, inside = [], False
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            ops.append(m.group(1))
    return ops


def phase_kernel(card, peak, block_frames: int):
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep
    from laughter_detection_icsi_tpu_torch.config import AST_FEAT, FEAT
    from laughter_detection_icsi_tpu_torch.inference import (
        InferenceSettings, strict_fp32, track_wave_len)
    from laughter_detection_icsi_tpu_torch.ops import fbank as fbank_ops
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

    rng = np.random.default_rng(0)
    noise = lambda shape: (rng.standard_normal(shape) * 0.1).astype(np.float32)
    snip = host_prep.snip_cfg(FEAT)
    bucket_n = host_prep.bucket_wave_len(InferenceSettings())
    check(bucket_n == 999_120, f"bucket length {bucket_n}")
    # fused_conv's whole track for SECONDS of audio: the frame count rounded
    # up to a multiple of the 6144-frame bucket, in one buffer.
    track_frames = -(-host_prep.num_frames(16000 * SECONDS) // 6144) * 6144
    track_n = track_wave_len(track_frames)
    check((track_frames, track_n) == (18_432, 2_949_360), f"whole track {track_frames}, {track_n}")
    train_n = 29_999 * snip.frame_shift_samples + snip.frame_length_samples
    # The AST preset's bucket batch (the clips cell's): 6,000 frames and 924
    # frames of clip context, 128 bins.
    ast_n = host_prep.bucket_wave_len(InferenceSettings(mode="clips", bucket_frames=6000), AST_FEAT)
    check(ast_n == 1_108_080, f"AST bucket length {ast_n}")
    silent = noise(32000)
    silent[6000:22000] = 0.0  # whole frames of silence: power at the floor
    tile = block_frames * 3 * FEAT.frame_shift_samples  # 3 whole blocks of frames
    cases = [
        ("n=16000", noise(16000), FEAT),
        ("n=48777", noise(48777), FEAT),
        ("n=399 (under one frame length)", noise(399), FEAT),
        ("n=80 (under one frame length)", noise(80), FEAT),
        ("multi-block, 549 frames", noise((2 * 256 + 37) * 160), FEAT),
        ("batch [3, 16777]", noise((3, 16777)), FEAT),
        ("int16-scaled, n=48777", speechlike(48777, seed=3) / np.float32(32768), FEAT),
        ("silent stretch, n=32000", silent, FEAT),
        (f"tile boundary, {3 * block_frames} frames", noise(tile), FEAT),
        (f"tile boundary, {3 * block_frames + 1} frames",
         noise(tile + FEAT.frame_shift_samples), FEAT),
        ("main-path bucket n=999120", noise(bucket_n), snip),
        ("multichannel bucket batch [4, 999120]", noise((4, bucket_n)), snip),
        (f"fused_conv whole track, {track_frames} frames n={track_n}",
         speechlike(track_n, seed=4) / np.float32(32768), snip),
        # The feature cache's bucket (data/feature_cache.py): 30,000 frames.
        (f"feature cache bucket, 30000 frames n={train_n}",
         speechlike(train_n, seed=5) / np.float32(32768), snip),
        # AST's features: 128 bins, Hann, 20 Hz to Nyquist, the eps floor.
        ("128 bins, n=48777", noise(48777), AST_FEAT),
        ("silent stretch, 128 bins, n=32000", silent, AST_FEAT),
        (f"clips bucket batch [6, {ast_n}], 128 bins", noise((6, ast_n)), AST_FEAT),
        (f"clips bucket row n={ast_n}, 128 bins",
         speechlike(ast_n, seed=6) / np.float32(32768), AST_FEAT),
    ]
    timed = {"main-path bucket n=999120": "the bucket",
             f"fused_conv whole track, {track_frames} frames n={track_n}": "the whole track",
             f"feature cache bucket, 30000 frames n={train_n}": "the feature cache's bucket",
             f"clips bucket row n={ast_n}, 128 bins": "the clips bucket row"}
    max_err = 0.0
    times = {}
    with strict_fp32():
        print(f"precision in force: {precision_setting()}")
        for label, wave, cfg in cases:
            x = torch.from_numpy(wave).cuda()
            got = fbank_cuda.fbank_cuda(x, cfg)
            want = fbank_ops.fbank(x, cfg)
            torch.cuda.synchronize()
            check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
            try:
                torch.testing.assert_close(got, want, **TOL)
            except AssertionError as e:
                raise PhaseError(f"{label}: kernel disagrees with the plain version: {e}")
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            print(f"  {label}: frames {got.shape[-2]}, max |kernel - plain| = {err:.3e}")
            if label.startswith("silent"):
                floor = torch.full_like(got, math.log(cfg.energy_floor))
                at_floor = int(torch.isclose(got, floor, rtol=0, atol=1e-5).sum().item())
                check(at_floor > 0, f"{label}: no feature at the energy floor")
                print(f"  {label}: {at_floor} features at log(energy_floor)")
            if x.ndim == 2:
                for c in range(x.shape[0]):
                    check(torch.equal(got[c], fbank_cuda.fbank_cuda(x[c].contiguous(), cfg)),
                          f"{label}: channel {c} differs from its own run")
                print("  batch rows equal each channel run alone (bit for bit)")
            if label in timed:
                times[timed[label]] = time_fbank(x, cfg, peak, card, timed[label])
        tone_errors(snip)
    return dict(
        name="fbank", route="cuda",
        source="laughter_detection_icsi_tpu_torch/csrc/fbank.cu",
        replaces="laughter_detection_icsi_tpu/ops/fbank_pallas.py:86",
        max_abs_err=max_err, **times["the bucket"],
        clips_row_ms=times["the clips bucket row"]["ms"],
    )


def tone_errors(snip) -> None:
    """The kernel and the plain version on ``tone()`` against float64
    truth on the card (the same folded basis and mel bank, in float64):
    the kernel within 1.5x JAX's own error there (``JAX_TONE_ERR``)."""
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep
    from laughter_detection_icsi_tpu_torch.ops import fbank as fbank_ops
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

    x = torch.from_numpy(tone()).cuda()
    t = host_prep.num_frames(x.shape[-1], snip)
    frames = x.double().unfold(0, snip.frame_length_samples, snip.frame_shift_samples)[:t]
    cos_eff, sin_eff = (torch.from_numpy(b).cuda().double()
                        for b in fbank_ops._effective_bases(snip))
    mel = ((frames @ cos_eff) ** 2 + (frames @ sin_eff) ** 2) @ torch.from_numpy(
        fbank_ops._mel_banks(snip)).cuda().double()
    truth = torch.log(torch.clamp(mel, min=snip.energy_floor))
    err = lambda feats: (feats.double() - truth).abs().max().item()
    kernel_err, plain_err = err(fbank_cuda.fbank_cuda(x, snip)), err(fbank_ops.fbank(x, snip))
    check(kernel_err <= 1.5 * JAX_TONE_ERR,
          f"tone: kernel {kernel_err:.3e} from float64, over 1.5x JAX's {JAX_TONE_ERR:.3e}")
    print(f"  tone (0.3 sin(0.05 n), then silence, +-2 LSB): from float64 truth, kernel "
          f"{kernel_err:.3e}, plain {plain_err:.3e}, JAX fbank_jit {JAX_TONE_ERR:.3e} (CPU); "
          f"kernel limit 1.5x JAX's = {1.5 * JAX_TONE_ERR:.3e}")


def time_fbank(x, cfg, peak, card, where: str) -> dict:
    """The kernel's, the plain version's and one cuBLAS fp32 matmul's
    (frames x the DFT basis, ~95% of the kernel's FLOPs) device times on the
    1-D wave ``x``, beside the 3xTF32 tensor-core bound and the fp32
    CUDA-core one; printed, and returned for the JSON kernels line."""
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep
    from laughter_detection_icsi_tpu_torch.ops import fbank as fbank_ops
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

    n = x.shape[-1]
    t = host_prep.num_frames(n, cfg)
    flen = cfg.frame_length_samples
    basis, mel, mel_range = fbank_cuda.kernel_constants(cfg, x.device)
    kernel_ms = cuda_ms(lambda: fbank_cuda.fbank_cuda(x, cfg))
    plain_ms = cuda_ms(lambda: fbank_ops.fbank(x, cfg))
    frames = x.as_strided((t, flen), (cfg.frame_shift_samples, 1)).contiguous()
    dft = basis[:flen].contiguous()
    library_ms = cuda_ms(lambda: torch.matmul(frames, dft))
    mel_nnz = int((mel_range[:, 1] - mel_range[:, 0]).sum().item())
    dft_flops, mel_flops = 2 * t * flen * dft.shape[1], 2 * t * mel_nnz
    nbytes = 4 * (n + basis.numel() + mel.numel() + mel_range.numel() + t * cfg.num_filters)
    bound_bytes_ms = 1e3 * nbytes / peak["bytes"]
    # The kernel's DFT is three TF32 products a term (3xTF32) on the tensor
    # cores; the mel sums run on the CUDA cores.  The fp32 bound is the
    # same work as fp32 FMAs on the CUDA cores only.
    bound_ops_ms = 1e3 * (3 * dft_flops / peak["tf32"] + mel_flops / peak["fp32"])
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_ops_ms >= bound_bytes_ms else "bytes"
    bound_fp32_ms = max(1e3 * (dft_flops + mel_flops) / peak["fp32"], bound_bytes_ms)
    print(f"fbank at {where} ({t} frames; DFT {dft_flops / 1e9:.3f} GFLOP = "
          f"{3 * dft_flops / 1e9:.3f} GFLOP in 3xTF32, mel {mel_flops / 1e9:.4f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB) on {card}:")
    print(f"  kernel {kernel_ms:.4f} ms | plain PyTorch {plain_ms:.4f} ms | "
          f"cuBLAS fp32 matmul [{t},{flen}]x[{flen},{dft.shape[1]}] {library_ms:.4f} ms")
    print(f"  3xTF32 tensor-core bound {bound_ms:.4f} ms ({bound_by}; "
          f"{100 * bound_ms / kernel_ms:.1f}% of it reached) | fp32 CUDA-core bound "
          f"{bound_fp32_ms:.4f} ms ({100 * bound_fp32_ms / kernel_ms:.1f}% of it reached)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_epilogue(card, peak) -> dict:
    """The conv epilogue (ops/bn_act_cuda.py) on the sweep's widest and
    narrowest conv outputs, in its heaviest form (conv bias, BN, a residual,
    ReLU).  In bf16: bit for bit the eager chain it replaces, and the
    kernel's and the chain's device times beside the byte bound (y and the
    residual read once, the output written once); the same for the
    kernel's NHWC form on the channels-last tensors.  In float32, the form
    phases 4-10 and 16 run: ``layers.conv_bn_act`` (the library's conv
    adds the bias, the kernel the rest) bit for bit the composed chain."""
    import torch
    import torch.nn.functional as F

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.models import layers as L
    from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda

    gen = torch.Generator().manual_seed(0)
    shapes = {"band": ((6144, 64, 7, 44), "strided"), "tail": ((6144, 16, 25, 11), "contiguous")}
    times = {}
    for where, (shape, layout) in shapes.items():
        n, c, h, w = shape
        bf = lambda *s: torch.randn(s, generator=gen).to("cuda", torch.bfloat16)
        y, bias = bf(n, c, h, w), bf(c) * 0.1
        bn = torch.nn.BatchNorm2d(c).to("cuda", torch.bfloat16).eval()
        with torch.no_grad():
            bn.weight.uniform_(0.7, 1.3)
            bn.bias.normal_(0.0, 0.1)
            bn.running_mean.normal_(0.0, 0.3)
            bn.running_var.uniform_(0.5, 2.0)
        res = bf(n, c, h + 2, w)[:, :, 2:] if layout == "strided" else bf(n, c, h, w)
        norm = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
        kernel = lambda: torch.ops.laughter_icsi_torch.bn_act(y, bias, *norm, res, True,
                                                              L.BN_EPS)
        chain = lambda: torch.relu(L.batch_norm(y + bias.reshape(1, -1, 1, 1), bn) + res)
        with torch.inference_mode():
            check(torch.equal(kernel().view(torch.int16), chain().view(torch.int16)),
                  f"the epilogue differs from the eager chain at the {where} shape")
            kernel_ms, chain_ms = cuda_ms(kernel), cuda_ms(chain)
        nbytes = 3 * y.numel() * y.element_size()
        bound_ms = 1e3 * nbytes / peak["bytes"]
        print(f"conv epilogue at the {where} shape {list(shape)} bf16, {layout} residual "
              f"({nbytes / 1e6:.1f} MB) on {card}: bit-equal to the eager chain; kernel "
              f"{kernel_ms:.4f} ms | eager chain {chain_ms:.4f} ms | byte bound "
              f"{bound_ms:.4f} ms ({100 * bound_ms / kernel_ms:.1f}% of it reached)")
        # The NHWC form (the bf16 classify step's): the same values
        # channels-last, the band's residual a crop along H of a taller
        # channels-last tensor, as the band convs pass it.
        cl = torch.channels_last
        y = y.contiguous(memory_format=cl)
        res = (bf(n, c, h + 2, w).contiguous(memory_format=cl)[:, :, 2:] if layout == "strided"
               else res.contiguous(memory_format=cl))
        before = bn_act_cuda.launches_nhwc
        with torch.inference_mode():
            got, want = kernel(), chain()
            check(bn_act_cuda.launches_nhwc - before == 1 and got.stride() == y.stride()
                  and torch.equal(got.view(torch.int16), want.view(torch.int16)),
                  f"the NHWC epilogue differs from the eager chain at the {where} shape")
            nhwc_ms = cuda_ms(kernel)
        print(f"  NHWC at the {where} shape, {layout} residual: bit-equal to the eager chain; "
              f"kernel {nhwc_ms:.4f} ms ({100 * bound_ms / nhwc_ms:.1f}% of the byte bound)")
        times[where] = dict(ms=kernel_ms, plain_ms=chain_ms, bound_ms=bound_ms, nhwc_ms=nhwc_ms)
        if layout == "strided":
            # The band's padded form: the result with the zero row above it
            # that the next band conv reads, against the unpadded kernel
            # followed by F.pad (the route it replaces).
            padded = lambda: torch.ops.laughter_icsi_torch.bn_act(y, bias, *norm, res, True,
                                                                  L.BN_EPS, 1, 0)
            pad_route = lambda: F.pad(kernel(), (0, 0, 1, 0))
            before = bn_act_cuda.launches_padded
            with torch.inference_mode():
                got, want = padded(), pad_route()
                check(bn_act_cuda.launches_padded - before == 1
                      and got.is_contiguous(memory_format=cl)
                      and torch.equal(got.view(torch.int16), want.view(torch.int16)),
                      f"the padded NHWC epilogue differs from F.pad of the unpadded one at the "
                      f"{where} shape")
                padded_ms, pad_route_ms = cuda_ms(padded), cuda_ms(pad_route)
            padded_bound_ms = 1e3 * (2 * h + h + 1) * n * c * w * y.element_size() / peak["bytes"]
            print(f"  NHWC padded at the {where} shape (a zero row above, {h + 1} rows out): "
                  f"bit-equal to F.pad of the unpadded kernel; kernel {padded_ms:.4f} ms "
                  f"({100 * padded_bound_ms / padded_ms:.1f}% of its byte bound "
                  f"{padded_bound_ms:.4f} ms) | unpadded kernel + F.pad {pad_route_ms:.4f} ms")
            times[where].update(padded_ms=padded_ms, padded_bound_ms=padded_bound_ms,
                                pad_route_ms=pad_route_ms)
        del y, res, got, want

        # float32 through conv_bn_act: a band's conv pads F alone (two rows
        # fewer out), the tail's pads both.
        band = layout == "strided"
        pad = (0, 1) if band else 1
        x = torch.randn(n, c, h + 2 if band else h, w, generator=gen).cuda()
        conv, bn = torch.nn.Conv2d(c, c, 3).cuda(), bn.float()
        res = torch.randn(n, c, h + 2 if band else h, w, generator=gen).cuda()
        res = res[:, :, 2:] if band else res
        before = bn_act_cuda.launches
        with torch.inference_mode(), inference.strict_fp32():
            got = L.conv_bn_act(x, conv, bn, residual=res, padding=pad)
            launched = bn_act_cuda.launches - before
            want = torch.relu(L.batch_norm(L.conv2d(x, conv, 1, pad), bn) + res)
        check(launched == 1 and got.shape == (n, c, h, w)
              and torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"float32 conv_bn_act differs from the composed chain at the {where} shape "
              f"({launched} launches)")
        print(f"  float32 at the {where} shape: layers.conv_bn_act (the bias in the library's "
              f"conv, one launch of the kernel) bit-equal to the composed chain")
        del x, got, want, res
    return dict(name="bn_act", route="cuda",
                source="laughter_detection_icsi_tpu_torch/csrc/bn_act.cu", replaces=None,
                bound_by="bytes", **{f"{k}_{where}": v for where, t in times.items()
                                     for k, v in t.items()})


def precision_setting() -> str:
    import torch

    return (f"cudnn.conv.fp32_precision={torch.backends.cudnn.conv.fp32_precision}, "
            f"cuda.matmul.fp32_precision={torch.backends.cuda.matmul.fp32_precision}")


def midway_threshold(probs: np.ndarray) -> float:
    """A threshold midway between neighbouring distinct probabilities at or
    just above the median, so that no rerun's rounding can flip a frame
    across it (bf16 probabilities repeat: they lie on its grid)."""
    srt = np.sort(probs.astype(np.float64))
    distinct = np.unique(srt)
    near = distinct[np.searchsorted(distinct, srt[len(srt) // 2]):][:50]
    near = near[: max(2, int(np.sum(near <= near[0] + 0.01)))]  # stay near the median
    j = int(np.argmax(np.diff(near)))
    thr = round(float(near[j] + near[j + 1]) / 2, 6)
    check(np.min(np.abs(srt - thr)) > 1e-6, f"threshold {thr} sits on a probability")
    return thr


def check_probs(probs: np.ndarray, shape, what: str) -> None:
    check(probs.shape == shape, f"{what}: probs shape {probs.shape} != {shape}")
    check(bool(np.isfinite(probs).all()), f"{what}: non-finite probabilities")
    check(bool((probs >= 0).all() and (probs <= 1).all()), f"{what}: probabilities outside [0, 1]")


def phase_main_path(card, work: Path):
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli import segment_laughter as cli
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
    from laughter_detection_icsi_tpu_torch.data import audio
    from laughter_detection_icsi_tpu_torch.eval import textgrid
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing
    from laughter_detection_icsi_tpu_torch.train import checkpoint

    preset = MODEL_MAP["resnet_base"]

    def build_model():
        return zoo.build(preset.model, dropout_rate=0.0,
                         linear_layer_size=preset.linear_layer_size,
                         filter_sizes=preset.filter_sizes)

    model = build_model()
    ckpt = checkpoint.save_checkpoint(str(work / "ckpt"), seeded_state_dict(model, seed=1))
    model.load_state_dict(checkpoint.load_checkpoint(ckpt)["state_dict"], strict=True)
    wav = work / "meeting.wav"
    pcm = speechlike(16000 * SECONDS, seed=2)
    audio.write_wav(str(wav), pcm, 16000)
    settings = inference.settings_from_flags(device="cuda", precision="float32")
    n_frames = host_prep.num_frames(len(pcm))
    n_buckets = -(-n_frames // settings.bucket_frames)
    print(f"resnet_base ResNetBigger {preset.filter_sizes}, head {preset.linear_layer_size}; "
          f"{SECONDS} s int16 audio = {n_frames} frames = {n_buckets} buckets of "
          f"{settings.bucket_frames}, chunk {settings.chunk}, {settings.precision}")

    pipe = inference.LaughterPipeline(model, settings=settings, device="cuda")
    probs, duration = pipe.probs_for_file(str(wav))  # also warms cuDNN up
    check_probs(probs, (n_frames,), "windows")
    thr = midway_threshold(probs)
    print(f"probs: min {probs.min():.4f}, median {np.median(probs):.4f}, max {probs.max():.4f}")

    # The main path, through the CLI a user calls; kernel launches counted.
    out = work / "out"
    fbank_cuda.launches = 0
    t0 = time.perf_counter()
    with EPILOGUES.count("windows"):
        rc = cli.main([
            "--model_path", ckpt, "--input_audio_file", str(wav), "--output_dir", str(out),
            "--thresholds", f"{thr},0.9", "--min_lengths", "0.2",
            "--save_to_textgrid", "True", "--save_to_audio_files", "False",
            "--device", "cuda", "--precision", "float32",
        ])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = fbank_cuda.launches
    check(rc == 0, f"CLI returned {rc}")
    check(launches == n_buckets, f"fbank kernel launched {launches} times for {n_buckets} buckets")
    print(f"CLI run: fbank kernel launched {launches} times ({n_buckets} buckets), the conv "
          f"epilogue {EPILOGUES.by_path['windows']} times (every conv of its classify steps)")

    grid = out / f"t_{thr}" / "l_0.2" / "meeting.TextGrid"
    want = smoothing.get_laughter_instances(probs, [thr], [0.2])[(thr, 0.2)]
    check(len(want) > 0, "no laughter instances at the median threshold")
    check(grid.is_file(), f"no TextGrid at {grid}")
    got = textgrid.read_laughter_intervals(str(grid))
    check(got == want, f"TextGrid intervals {got[:3]}... != smoothing {want[:3]}...")
    print(f"TextGrid reads back: {len(got)} instances at threshold {thr}, min_length 0.2")

    # The card against the port on the CPU, on a short clip.
    clip = pcm[: 16000 * 5]
    cpu_model = build_model()
    cpu_model.load_state_dict(model.state_dict())
    cpu_pipe = inference.LaughterPipeline(
        cpu_model, settings=inference.InferenceSettings(chunk=256, bucket_frames=512),
        device="cpu",
    )
    d_cpu = np.abs(pipe.probs_for_waveform(clip) - cpu_pipe.probs_for_waveform(clip)).max()
    check(d_cpu <= 1e-4, f"card vs CPU probs differ by {d_cpu:.3e} > 1e-4")
    print(f"card vs CPU, 5 s clip: max |diff| = {d_cpu:.3e} (limit 1e-4)")

    # Shared stem against the naive window batch, on the card.
    clip = pcm[: 16000 * 20]
    naive = inference.LaughterPipeline(
        model, device="cuda",
        settings=inference.settings_from_flags(device="cuda", precision="float32",
                                               shared_stem=False),
    )
    d_stem = np.abs(pipe.probs_for_waveform(clip) - naive.probs_for_waveform(clip)).max()
    check(d_stem <= 1e-5, f"shared stem vs naive differ by {d_stem:.3e} > 1e-5")
    print(f"shared stem vs naive windows, 20 s clip: max |diff| = {d_stem:.3e} (limit 1e-5)")

    # End to end, warm: file read -> probs -> smoothing, as segment_file times it.
    took = [pipe.segment_file(str(wav), [thr], [0.2])[1] for _ in range(3)]
    best = min(took)
    torch.cuda.reset_peak_memory_stats()
    pipe.segment_file(str(wav), [thr], [0.2])
    peak = torch.cuda.max_memory_allocated()
    print(f"e2e segment_file on {card}: {SECONDS} s audio in "
          f"{', '.join(f'{s:.4f}' for s in took)} s -> {duration / best:.1f}x realtime "
          f"(best of 3); CLI wall time incl. model load {cli_s:.3f} s; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    device_breakdown("segment_file", lambda: pipe.segment_file(str(wav), [thr], [0.2]), best,
                     work / "segment_file.trace.json")
    return dict(launches=launches, model=model, build_model=build_model, ckpt=ckpt, wav=wav,
                pcm=pcm, probs=probs, thr=thr, pipe=pipe, n_buckets=n_buckets,
                x_rt=duration / best, peak=peak)


def phase_fused_conv(card, work: Path, ctx: dict) -> int:
    """mode='fused_conv' through the CLI; returns its kernel launches."""
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli import segment_laughter as cli
    from laughter_detection_icsi_tpu_torch.config import FEAT
    from laughter_detection_icsi_tpu_torch.data import audio
    from laughter_detection_icsi_tpu_torch.eval import textgrid
    from laughter_detection_icsi_tpu_torch.models import fully_conv
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing

    model, wav, pcm = ctx["model"], ctx["wav"], ctx["pcm"]
    settings = inference.settings_from_flags(device="cuda", precision="float32", mode="fused_conv")
    pipe = inference.LaughterPipeline(model, settings=settings, device="cuda")
    probs, duration = pipe.probs_for_file(str(wav))  # also warms cuDNN up
    check_probs(probs, ctx["probs"].shape, "fused_conv")
    thr = midway_threshold(probs)
    print(f"fused_conv probs: min {probs.min():.4f}, median {np.median(probs):.4f}, "
          f"max {probs.max():.4f}; max |fused_conv - windows| = "
          f"{np.abs(probs - ctx['probs']).max():.3f} (another model of the audio, not parity)")

    out = work / "out_fused"
    fbank_cuda.launches = 0
    with EPILOGUES.count("fused_conv"):  # no classify step: owes 0
        rc = cli.main([
            "--model_path", ctx["ckpt"], "--input_audio_file", str(wav), "--output_dir", str(out),
            "--thresholds", f"{thr}", "--min_lengths", "0.2", "--save_to_textgrid", "True",
            "--save_to_audio_files", "False", "--mode", "fused_conv", "--device", "cuda",
            "--precision", "float32",
        ])
    torch.cuda.synchronize()
    launches = fbank_cuda.launches
    check(rc == 0, f"CLI returned {rc}")
    check(launches == 1, f"fused_conv: fbank kernel launched {launches} times for one file")
    print(f"CLI run (--mode fused_conv): fbank kernel launched {launches} time for the file")
    grid = out / f"t_{thr}" / "l_0.2" / "meeting.TextGrid"
    want = smoothing.get_laughter_instances(probs, [thr], [0.2])[(thr, 0.2)]
    check(len(want) > 0 and grid.is_file(), f"no instances or no TextGrid at {grid}")
    got = textgrid.read_laughter_intervals(str(grid))
    check(got == want, f"TextGrid intervals {got[:3]}... != smoothing {want[:3]}...")
    print(f"TextGrid reads back: {len(got)} instances at threshold {thr}, min_length 0.2")

    # The card against the port on the CPU, on a short clip, same settings.
    clip = pcm[: 16000 * 5]
    small = inference.InferenceSettings(bucket_frames=512, mode="fused_conv")
    cpu_model = ctx["build_model"]()
    cpu_model.load_state_dict(model.state_dict())
    d_cpu = np.abs(
        inference.LaughterPipeline(model, settings=small, device="cuda").probs_for_waveform(clip)
        - inference.LaughterPipeline(cpu_model, settings=small, device="cpu").probs_for_waveform(clip)
    ).max()
    check(d_cpu <= 1e-4, f"fused_conv card vs CPU probs differ by {d_cpu:.3e} > 1e-4")
    print(f"card vs CPU, 5 s clip: max |diff| = {d_cpu:.3e} (limit 1e-4)")

    # The blocked track against the whole track, on the card (3,000 frames).
    with torch.inference_mode(), inference.strict_fp32():
        x = torch.from_numpy(pcm[: 16000 * 30]).cuda().float() / 32768.0
        feats = fbank_cuda.fbank_cuda(x, FEAT)
        d_blk = (fully_conv.fully_conv_probs_blocked(model, feats)
                 - fully_conv.fully_conv_probs(model, feats)).abs().max().item()
    check(d_blk <= 1e-5, f"blocked vs whole-track fully-conv differ by {d_blk:.3e} > 1e-5")
    print(f"blocked vs whole track, {feats.shape[0]} frames: max |diff| = {d_blk:.3e} (limit 1e-5)")

    run = lambda: pipe.segment_file(str(wav), [thr], [0.2])
    took = [run()[1] for _ in range(3)]
    best = min(took)
    torch.cuda.reset_peak_memory_stats()
    run()
    peak = torch.cuda.max_memory_allocated()
    print(f"e2e segment_file (fused_conv) on {card}: {SECONDS} s audio in "
          f"{', '.join(f'{s:.4f}' for s in took)} s -> {duration / best:.1f}x realtime "
          f"(best of 3); peak device memory {peak / 2**30:.3f} GiB")
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        host_prep.host_pad_waveform(audio.read_int16(str(wav))[0])
        host.append(time.perf_counter() - t0)
    print(f"  of which the host's file read + reflection pad: {1e3 * min(host):.2f} ms "
          f"(host clock, best of 3)")
    device_breakdown("segment_file (fused_conv)", run, best, work / "fused_conv.trace.json")
    ctx.update(fused_probs=probs, fused_x_rt=duration / best, fused_peak=peak)

    # A one-hour channel (the audio 24 times over): the blocks go through the
    # stack fully_conv.MAX_BLOCKS at a time; held against one batch of all.
    hour = np.tile(pcm, 3600 // SECONDS)
    t_hour = host_prep.num_frames(len(hour))
    took_h = []
    for _ in range(2):  # the first call meets the group shapes cold
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p_hour = pipe.probs_for_waveform(hour)
        took_h.append(time.perf_counter() - t0)
    peak_hour = torch.cuda.max_memory_allocated()
    check_probs(p_hour, (t_hour,), "fused_conv, one hour")
    with torch.inference_mode(), inference.strict_fp32():
        feats = fbank_cuda.fbank_cuda(torch.from_numpy(hour).cuda().float() / 32768.0, FEAT)
        nb = -(-feats.shape[0] // 1024)
        base = torch.cuda.memory_allocated()
        peaks, out = [], []
        for max_blocks in (fully_conv.MAX_BLOCKS, nb):
            torch.cuda.reset_peak_memory_stats()
            out.append(fully_conv.fully_conv_probs_blocked(model, feats, max_blocks=max_blocks))
            peaks.append(torch.cuda.max_memory_allocated() - base)
        d_grp = (out[0] - out[1]).abs().max().item()
    check(d_grp <= 1e-5, f"one hour: {fully_conv.MAX_BLOCKS}-block groups vs one batch of {nb} "
                         f"differ by {d_grp:.3e} > 1e-5")
    print(f"one hour ({t_hour} frames, {nb} blocks) on {card}: segment by probs_for_waveform in "
          f"{', '.join(f'{s:.4f}' for s in took_h)} s -> {3600 / took_h[-1]:.1f}x realtime "
          f"(warm call), peak device memory {peak_hour / 2**30:.3f} GiB")
    print(f"  fully_conv_probs_blocked over its features: groups of {fully_conv.MAX_BLOCKS} "
          f"blocks peak {peaks[0] / 2**30:.3f} GiB above the features, one batch of {nb} "
          f"blocks {peaks[1] / 2**30:.3f} GiB; max |groups - one batch| = {d_grp:.3e} "
          f"(limit 1e-5)")
    return launches


def phase_streaming(card, work: Path, ctx: dict) -> int:
    """The 150 s file replayed through cli/serve.py; returns its kernel
    launches (warm-up included)."""
    import contextlib
    import io

    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli import serve
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing

    probs, thr, pcm, pipe = ctx["probs"], ctx["thr"], ctx["pcm"], ctx["pipe"]
    saved = work / "serve_probs.npy"
    stdout = io.StringIO()
    fbank_cuda.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), EPILOGUES.count("serve"):
        rc = serve.main([
            "--model_path", ctx["ckpt"], "--input", str(ctx["wav"]), "--threshold", str(thr),
            "--min_length", "0.2", "--chunk_ms", "250", "--save_probs", str(saved),
            "--device", "cuda", "--precision", "float32",
        ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fbank_cuda.launches
    check(rc == 0, f"serve returned {rc}")
    lines = [json.loads(line) for line in stdout.getvalue().splitlines()]
    check(lines[0]["type"] == "ready" and lines[-1]["type"] == "done", "serve NDJSON framing")
    check(lines[0]["device"].startswith("cuda"), f"serve ran on {lines[0]['device']}")
    check(launches == ctx["n_buckets"] + 1,
          f"serve: fbank kernel launched {launches} times for {ctx['n_buckets']} buckets + warm-up")
    got = np.load(saved)
    check(got.shape == (1, len(probs)) and np.array_equal(got[0], probs),
          "streamed probabilities differ from the offline ones")
    fps = len(probs) / (len(pcm) / 16000)
    want = smoothing.get_laughter_instances(probs, [thr], [0.2], fps=fps)[(thr, 0.2)]
    want = [(round(s, 3), round(e, 3)) for s, e in want]
    events = [(e["start"], e["end"]) for e in lines if e["type"] == "event"]
    check(events == want and len(events) > 0, f"serve events {events[:3]}... != offline {want[:3]}...")
    print(f"serve replay (--chunk_ms 250): probabilities bit-equal to offline; {len(events)} "
          f"events equal the offline smoothing; fbank kernel launched {launches} times "
          f"({ctx['n_buckets']} buckets + 1 warm-up), the conv epilogue "
          f"{EPILOGUES.by_path['serve']} times; wall {wall:.3f} s incl. model load")

    # The feed that completes bucket 0, on a warm pipeline.
    sess = inference.StreamingSession(pipe)
    n0 = pipe.wave_len - host_prep.pad_amounts(len(pcm))[0] - 4000
    check(len(sess.feed(pcm[:n0])) == 0, "a bucket completed early")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = sess.feed(pcm[n0 : n0 + 4000])
    end.record()
    end.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    check(len(out) == pipe.settings.bucket_frames, f"the feed gave {len(out)} frames")
    print(f"a 250 ms feed that completes a bucket: {start.elapsed_time(end):.2f} ms between "
          f"CUDA events around it, {host_ms:.2f} ms on the host clock; bucket_latency_s "
          f"{lines[0]['bucket_latency_s']} (audio a bucket waits for) on {card}")
    return launches


def phase_multichannel(card, work: Path, ctx: dict) -> int:
    """4 channels through ShardedPipeline and serve --channels 4; returns
    the kernel launches of one offline batch."""
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing
    from laughter_detection_icsi_tpu_torch.parallel import (
        ShardedPipeline, ShardedStreamingSession)

    n = 16000 * SECONDS
    chans = [speechlike(n - (777 if c == 3 else 0), seed=10 + c) for c in range(4)]
    spipe = ShardedPipeline(ctx["model"], device="cuda",
                            settings=inference.settings_from_flags(device="cuda", precision="float32"))
    spipe.probs_for_waveforms(chans)  # warms cuDNN up for the batch
    fbank_cuda.launches = 0
    with EPILOGUES.count("multichannel"):
        rows = spipe.probs_for_waveforms(chans)
    torch.cuda.synchronize()
    launches = fbank_cuda.launches
    padded, ts = zip(*(host_prep.host_pad_waveform(w) for w in chans))
    n_batches = len(list(spipe.bucket_batches(padded, ts, int16_in=True)))
    check(launches == n_batches, f"multichannel: {launches} launches for {n_batches} bucket batches")
    for r, t in zip(rows, ts):
        check_probs(r, (t,), "multichannel")
    d_row = max(np.abs(r - ctx["pipe"].probs_for_waveform(w)).max() for r, w in zip(rows, chans))
    check(d_row <= 1e-5, f"multichannel rows vs single-channel differ by {d_row:.3e} > 1e-5")
    print(f"4 channels x {SECONDS} s (one 777 samples shorter): fbank kernel launched {launches} "
          f"times ({n_batches} bucket batches), the conv epilogue "
          f"{EPILOGUES.by_path['multichannel']} times; rows vs LaughterPipeline max |diff| = "
          f"{d_row:.3e} (limit 1e-5)")

    m = n - 777  # a live meeting's channels advance together
    equal = [w[:m] for w in chans]
    want = spipe.probs_for_waveforms(equal)
    ctx["mc_equal_rows"] = want
    sess = ShardedStreamingSession(spipe, n_channels=4)
    outs = [sess.feed([w[lo : lo + 4000] for w in equal]) for lo in range(0, m, 4000)]
    full = np.concatenate(outs + [sess.finish()], axis=1)
    check(full.shape == (4, len(want[0])) and all(np.array_equal(a, b) for a, b in zip(full, want)),
          "ShardedStreamingSession differs from the offline batch")
    print("ShardedStreamingSession (250 ms feeds) equals the offline batch bit for bit")

    run = lambda: spipe.probs_for_waveforms(chans)
    took = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        took.append(time.perf_counter() - t0)
    audio_s = sum(len(w) for w in chans) / 16000
    torch.cuda.reset_peak_memory_stats()
    run()
    peak = torch.cuda.max_memory_allocated()
    print(f"multichannel batch on {card}: {audio_s:.3f} audio-seconds in "
          f"{', '.join(f'{s:.4f}' for s in took)} s -> {audio_s / min(took):.1f} audio-s per "
          f"wall-s (best of 3); peak device memory {peak / 2**30:.3f} GiB")
    device_breakdown("probs_for_waveforms (4 channels)", run, min(took),
                     work / "multichannel.trace.json")
    ctx.update(mc_chans=chans, mc_rows=rows, mc_rate=audio_s / min(took), mc_peak=peak)
    # Each channel is classified alone, so the peak does not grow with the
    # channel count: 9 channels of 20 s (an ICSI meeting can have 9 or more).
    nine = [speechlike(16000 * 20, seed=30 + c) for c in range(9)]
    spipe.probs_for_waveforms(nine)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spipe.probs_for_waveforms(nine)
    took9 = time.perf_counter() - t0
    print(f"9 channels x 20 s: {9 * 20 / took9:.1f} audio-s per wall-s (one warm call), peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # serve --channels 4: interleaved s16le on stdin, in a process of its own.
    seg = [w[: min(16000 * 20, m)] for w in chans]
    offline = spipe.probs_for_waveforms(seg)
    thr = midway_threshold(np.concatenate(offline))
    want = [[(round(s, 3), round(e, 3)) for s, e in
             smoothing.get_laughter_instances(p, [thr], [0.2])[(thr, 0.2)]] for p in offline]
    proc = subprocess.run(
        [sys.executable, "-m", "laughter_detection_icsi_tpu_torch.cli.serve",
         "--model_path", ctx["ckpt"], "--channels", "4", "--threshold", str(thr),
         "--min_length", "0.2", "--device", "cuda", "--precision", "float32"],
        input=np.stack(seg, axis=1).astype("<i2").tobytes(), cwd=REPO,
        capture_output=True, timeout=600,
    )
    check(proc.returncode == 0, f"serve --channels 4 exited {proc.returncode}: "
          f"{proc.stderr.decode()[-2000:]}")
    lines = [json.loads(line) for line in proc.stdout.decode().splitlines()]
    check(lines[0]["type"] == "ready" and lines[0]["channels"] == 4, "serve: no ready line")
    for c in range(4):
        got = [(e["start"], e["end"]) for e in lines if e["type"] == "event" and e["channel"] == c]
        check(got == want[c], f"serve channel {c}: events {got[:3]}... != offline {want[c][:3]}...")
    print(f"serve --channels 4 over stdin (20 s, a subprocess): every channel's events equal its "
          f"offline events ({', '.join(str(len(w)) for w in want)} events)")
    ctx["mc_shard_launches"] = local_shards(card, ctx, chans, rows, equal, seg, thr, want)
    return launches


def serve_in_process(argv, pcm: bytes) -> list:
    """``cli/serve.main(argv)`` in this process on ``pcm`` as its stdin:
    the NDJSON lines it writes."""
    import contextlib
    import io
    import types

    from laughter_detection_icsi_tpu_torch.cli import serve

    out, stdin = io.StringIO(), sys.stdin
    sys.stdin = types.SimpleNamespace(buffer=io.BytesIO(pcm))
    try:
        with contextlib.redirect_stdout(out):
            rc = serve.main(argv)
    finally:
        sys.stdin = stdin
    check(rc == 0, f"serve {' '.join(argv)} returned {rc}")
    return [json.loads(line) for line in out.getvalue().splitlines()]


def shard_run(card, ctx, devices, chans, rows, equal, seg, thr, want, atol: float, what: str,
              path: str):
    """One shard list through phase 7's multichannel paths: float32 and
    bfloat16 rows against the one-shard rows (``rows``, and a one-shard
    bf16 run here) within ``atol`` (0: bit-equal), one fbank launch per
    shard per bucket batch, the streaming session against the one-shard
    offline batch of ``equal``, and ``serve --channels 4`` in this process
    against the one-shard events ``want`` of ``seg``.  The float32 batch's
    conv epilogue launches are kept under ``path``.  Returns (launches of
    the float32 batch, its best wall of 3, the pipeline)."""
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda
    from laughter_detection_icsi_tpu_torch.parallel import (
        ShardedPipeline, ShardedStreamingSession)

    sync_all = lambda: [torch.cuda.synchronize(d) for d in set(devices)]
    diff = lambda a, b: max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    f32 = inference.settings_from_flags(device="cuda", precision="float32")
    spipe = ShardedPipeline(ctx["model"], settings=f32, devices=devices)
    spipe.probs_for_waveforms(chans)  # every shard's cuDNN choices, off the count
    sync_all()
    fbank_cuda.launches = 0
    with EPILOGUES.count(path):
        got = spipe.probs_for_waveforms(chans)
    sync_all()
    launches = fbank_cuda.launches
    padded, ts = zip(*(host_prep.host_pad_waveform(w) for w in chans))
    n_batches = len(list(spipe.bucket_batches(padded, ts, int16_in=True)))
    check(launches == n_batches * len(devices),
          f"{what}: {launches} fbank launches for {n_batches} bucket batches x {len(devices)} shards")
    d32 = diff(got, rows)
    check(d32 <= atol if atol else all(np.array_equal(a, b) for a, b in zip(got, rows)),
          f"{what}: float32 rows differ from one shard's by {d32:.3e} (limit {atol or 'equal'})")
    took = []
    for _ in range(3):
        t0 = time.perf_counter()
        spipe.probs_for_waveforms(chans)
        took.append(time.perf_counter() - t0)
    bf16 = inference.settings_from_flags(device="cuda")
    one16 = ShardedPipeline(ctx["model"], device=devices[0], settings=bf16)
    two16 = ShardedPipeline(ctx["model"], devices=devices, settings=bf16)
    want16 = one16.probs_for_waveforms(chans)
    two16.probs_for_waveforms(chans)  # warm
    got16 = two16.probs_for_waveforms(chans)
    d16 = diff(got16, want16)
    check(bf16.precision == "bfloat16" and (d16 <= atol if atol else all(
        np.array_equal(a, b) for a, b in zip(got16, want16))),
          f"{what}: bfloat16 rows differ from one shard's by {d16:.3e} (limit {atol or 'equal'})")
    print(f"{what} ({', '.join(map(str, devices))}): {launches} fbank launches for {n_batches} "
          f"bucket batches x {len(devices)} shards; rows vs one shard max |diff| float32 "
          f"{d32:.3e}, bfloat16 {d16:.3e} (limit {atol or 'bit-equal'})")

    m = len(equal[0])
    offline = spipe.probs_for_waveforms(equal) if atol else None
    sess = ShardedStreamingSession(spipe, n_channels=len(equal))
    outs = [sess.feed([w[lo : lo + 4000] for w in equal]) for lo in range(0, m, 4000)]
    full = np.concatenate(outs + [sess.finish()], axis=1)
    ref = ctx["mc_equal_rows"]
    ds = max(float(np.abs(a - b).max()) for a, b in zip(full, ref))
    check(full.shape == (len(equal), len(ref[0])) and (ds <= atol if atol else ds == 0.0),
          f"{what}: the streaming session differs from the one-shard batch by {ds:.3e}")
    if offline is not None:
        check(all(np.array_equal(a, b) for a, b in zip(full, offline)),
              f"{what}: the streaming session differs from its own offline batch")
    lines = serve_in_process(
        ["--model_path", ctx["ckpt"], "--channels", str(len(seg)), "--threshold", str(thr),
         "--min_length", "0.2", "--device", ",".join(map(str, devices)),
         "--precision", "float32"],
        np.stack(seg, axis=1).astype("<i2").tobytes())
    check(lines[0]["type"] == "ready" and lines[0]["devices"] == [str(d) for d in devices],
          f"{what}: serve's ready line {lines[0]}")
    for c in range(len(seg)):
        events = [(e["start"], e["end"]) for e in lines
                  if e["type"] == "event" and e["channel"] == c]
        check(events == want[c], f"{what}: serve channel {c}: events {events[:3]}... != one "
              f"shard's {want[c][:3]}...")
    print(f"{what}: ShardedStreamingSession (250 ms feeds) vs the one-shard batch max |diff| "
          f"{ds:.3e}; serve --channels {len(seg)} --device {','.join(map(str, devices))} (in "
          f"this process) gives one shard's events")
    return launches, min(took), spipe


def local_shards(card, ctx, chans, rows, equal, seg, thr, want) -> int:
    """Phase 7 over several shards in one process: (a) two shards of card 0
    bit-equal to one shard, with the host syncs of one bucket batch
    named; (b) every visible card, rows within 1e-6, the aggregate rate
    beside one card's.  Returns (a)'s fbank launches."""
    import warnings

    import torch

    from laughter_detection_icsi_tpu_torch import host_prep
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda
    from laughter_detection_icsi_tpu_torch.parallel import mesh

    audio_s = sum(len(w) for w in chans) / 16000
    two = [torch.device("cuda", 0)] * 2
    launches, took, spipe = shard_run(card, ctx, two, chans, rows, equal, seg, thr, want, 0.0,
                                      "(a) two shards of one card", "multichannel_two_shards")
    padded, ts = zip(*(host_prep.host_pad_waveform(w) for w in chans))
    batch, valid, _ = next(spipe.bucket_batches(padded, ts, int16_in=True))
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the mode's own "prototype" note
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            probs = spipe._bucket_probs_batch(batch, valid)
            n_body = len(caught)
            probs.cpu()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught]
    check(n_body == 0, f"(a) one bucket batch's body synchronizes the host: {syncs[:n_body]}")
    print(f"(a) host syncs under torch.cuda.set_sync_debug_mode('warn'): one bucket batch of "
          f"{len(batch)} rows over 2 shards {n_body} (uploads pinned and non-blocking, no read "
          f"back); its read-back {len(syncs) - n_body} ({'; '.join(syncs[n_body:]) or 'none'})")
    print(f"(a) {audio_s:.3f} audio-s in {took:.4f} s on two shards of {card}: "
          f"{audio_s / took:.1f} audio-s per wall-s (best of 3) against one shard's "
          f"{ctx['mc_rate']:.1f}")

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"(b) did not run: {n_cards} card visible, so there is no second card to shard "
              f"over (not a pass)")
        return launches
    cards = mesh.local_devices("cuda")
    check(len(cards) == n_cards, f"(b) local_devices('cuda') gave {cards} for {n_cards} cards")
    _, took_n, _ = shard_run(card, ctx, cards, chans, rows, equal, seg, thr, want, 1e-6,
                             f"(b) every card ({n_cards})", "multichannel_every_card")
    info = fbank_cuda.kernel_constants.cache_info()
    print(f"(b) {n_cards} cards: {audio_s:.3f} audio-s in {took_n:.4f} s, {audio_s / took_n:.1f} "
          f"audio-s per wall-s (best of 3) against one card's {ctx['mc_rate']:.1f} "
          f"({audio_s / took_n / ctx['mc_rate']:.3f}x; 4 channels, one a card or fewer); "
          f"kernel_constants cache {info.currsize} entries, {info.misses} misses")
    sweep_over_cards(ctx, n_cards)
    return launches


def sweep_over_cards(ctx, n_cards: int) -> None:
    """(b): ``cli/sweep`` with ``--device cuda`` on a small corpus (Bmr021
    4 x 60 s, Bns001 3 x 30 s) splits each meeting over every card and
    writes the TextGrids of ``--device cuda:0``, byte for byte; a
    ``ShardedPipeline`` over ``mesh.local_devices("cuda")`` holds every
    card."""
    import contextlib
    import filecmp
    import io

    from laughter_detection_icsi_tpu_torch.cli import sweep
    from laughter_detection_icsi_tpu_torch.parallel import ShardedPipeline, mesh

    root = Path(ctx["work"]) / "cards"
    corpus = (("Bmr021", 4, 60, "pcm"), ("Bns001", 3, 30, "pcm"))
    tdir, adir, _ = write_sweep_corpus(root / "corpus", root / "cache", corpus)
    audio_s = sum(n * secs for _, n, secs, _ in corpus) - 777 / 16000
    outs, walls = {}, {}
    for dev in ("cuda", "cuda:0"):
        out, text = root / dev.replace(":", "_"), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = sweep.main(["--audio_dir", str(adir), "--transcript_dir", str(tdir),
                             "--output_dir", str(out), "--split", "all", "--model_path",
                             ctx["ckpt"], "--device", dev, "--precision", "float32"])
        walls[dev] = time.perf_counter() - t0
        want = n_cards if dev == "cuda" else 1
        check(rc == 0 and f"shards: {want} " in text.getvalue(),
              f"(b) sweep --device {dev}: rc {rc}, {text.getvalue()[-400:]}")
        outs[dev] = out / "all"
    a, b = outs["cuda"], outs["cuda:0"]
    grids = sorted(q.relative_to(a) for q in a.rglob("*.TextGrid"))
    check(bool(grids) and grids == sorted(q.relative_to(b) for q in b.rglob("*.TextGrid"))
          and all(filecmp.cmp(a / g, b / g, shallow=False) for g in grids),
          "(b) sweep --device cuda: TextGrids differ from --device cuda:0's")
    n_shards = ShardedPipeline(ctx["model"], devices=mesh.local_devices("cuda")).n_shards
    check(n_shards == n_cards, f"(b) a ShardedPipeline on every card holds {n_shards} shards")
    print(f"(b) sweep --device cuda over {n_cards} cards: {len(grids)} TextGrids byte-equal to "
          f"--device cuda:0's ({walls['cuda']:.2f} s and {walls['cuda:0']:.2f} s for "
          f"{audio_s:.3f} audio-s, model load and warm-up included); a ShardedPipeline on "
          f"every card: {n_shards} shards")


#: The corpus phase 8 sweeps: (meeting, channels, seconds, encoding); 69.3
#: min of audio.  Bmr021 and Bns001 are the dev split, Bmr013 is in test,
#: Bro012 in train.  Bro012 is a meeting in ICSI's own encoding, shorten,
#: as long as the port's numpy encoder writes in about a minute.
SWEEP_CORPUS = (("Bmr021", 4, 600, "pcm"), ("Bns001", 3, 300, "pcm"), ("Bmr013", 2, 30, "shorten"),
                ("Bro012", 4, 200, "shorten"))
SHORTEN_MEETING = "Bro012"


def shorten_channel(path: str, n: int, seed: int) -> str:
    """``speechlike(n, seed)`` written as shorten SPHERE at ``path`` (a
    worker of ``write_sweep_corpus``'s process pool); returns the path."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from laughter_detection_icsi_tpu_torch.data import audio

    tmp = f"{path}.tmp.{os.getpid()}"
    audio.write_sphere_shorten(tmp, speechlike(n, seed), 16000)
    os.replace(tmp, path)
    return path


def write_sweep_corpus(root: Path, cache: Path, corpus=None):
    """An ICSI-layout corpus under ``root``: ``transcripts/preambles.mrt``
    and one ``<meeting>.mrt`` each, whose participants have, every 20 s, a
    pure laugh, speech, a noise, a laugh next to speech (invalid) and a
    0.1 s laugh (too short: invalid); ``audio/<meeting>/chanN.sph`` int16
    audio, one Bmr021 channel 777 samples short; the meetings of
    ``corpus`` (default ``SWEEP_CORPUS``).  The shorten channels are
    encoded in parallel processes into ``cache`` (keyed on the encoder's
    source, the length and the seed) unless already there, then copied.
    Returns (transcript dir, audio dir, {meeting: [paths]})."""
    import concurrent.futures
    import hashlib
    import multiprocessing

    from laughter_detection_icsi_tpu_torch.data import audio

    tdir, adir = root / "transcripts", root / "audio"
    tdir.mkdir(parents=True)
    key = hashlib.sha256(b"".join(
        (REPO / "laughter_detection_icsi_tpu_torch" / "data" / f).read_bytes()
        for f in ("shorten.py", "audio.py"))).hexdigest()[:12]
    shorten_jobs = []
    seg = lambda p, a, b, body: (
        f'    <Segment StartTime="{a}" EndTime="{b}" Participant="{p}">{body}</Segment>')
    preambles, paths = [], {}
    for m, n_ch, secs, encoding in corpus or SWEEP_CORPUS:
        parts = [f"me{m[-3:]}{c}" for c in range(n_ch)]
        preambles.append(
            f'  <Meeting Session="{m}"><Preamble><Participants>'
            + "".join(f'<Participant Name="{p}" Channel="chan{c}"/>' for c, p in enumerate(parts))
            + "</Participants></Preamble></Meeting>")
        segs = []
        for c, p in enumerate(parts):
            for t in range(5 + 3 * c, secs - 14, 20):
                segs += [seg(p, t, t + 1.5, '\n      <VocalSound Description="laugh"/>\n    '),
                         seg(p, t + 2, t + 6, "words and more words"),
                         seg(p, t + 7, t + 8, '<NonVocalSound Description="door"/>'),
                         seg(p, t + 9, t + 10, '<VocalSound Description="laugh"/> ha'),
                         seg(p, t + 11, t + 11.1, '<VocalSound Description="laugh"/>')]
        (tdir / f"{m}.mrt").write_text(
            f'<?xml version="1.0" encoding="UTF-8"?>\n<Meeting Session="{m}">\n'
            f'  <Transcript StartTime="0.0" EndTime="{secs}.0">\n' + "\n".join(segs)
            + "\n  </Transcript>\n</Meeting>\n")
        (adir / m).mkdir(parents=True)
        paths[m] = []
        for c in range(n_ch):
            n = 16000 * secs - (777 if (m, c) == ("Bmr021", 3) else 0)
            seed = 100 + 10 * len(paths) + c
            paths[m].append(str(adir / m / f"chan{c}.sph"))
            if encoding == "shorten":
                cached = cache / f"shorten_{key}_{n}_{seed}.sph"
                shorten_jobs.append((str(cached), n, seed, paths[m][-1]))
            else:
                audio.write_sphere(paths[m][-1], speechlike(n, seed=seed), 16000)
    (tdir / "preambles.mrt").write_text(
        '<?xml version="1.0" encoding="UTF-8"?>\n<Preambles>\n' + "\n".join(preambles)
        + "\n</Preambles>\n")
    todo = [job for job in shorten_jobs if not Path(job[0]).is_file()]
    if todo:
        cache.mkdir(parents=True, exist_ok=True)
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(8, len(todo)), mp_context=multiprocessing.get_context("spawn")) as ex:
            for done in ex.map(shorten_channel, *zip(*(job[:3] for job in todo))):
                print(f"  encoded {Path(done).name}")
    for cached, _, _, path in shorten_jobs:
        shutil.copyfile(cached, path)
    return tdir, adir, paths


class HostSpans:
    """Host-clock spans of the calls to functions wrapped in place, by
    name; ``restore`` puts the functions back."""

    def __init__(self):
        self.spans, self._saved = {}, []

    def wrap(self, module, name: str) -> None:
        fn = getattr(module, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:  # list.append is atomic: safe from the decode threads
                self.spans.setdefault(name, []).append((t0, time.perf_counter()))

        self._saved.append((module, name, fn))
        setattr(module, name, timed)

    def restore(self) -> None:
        for module, name, fn in self._saved:
            setattr(module, name, fn)

    def covered(self, name: str) -> float:
        """Seconds of the wall that at least one call of ``name`` covers
        (calls from a thread pool overlap)."""
        total, end = 0.0, -math.inf
        for a, b in sorted(self.spans.get(name, [])):
            if b > end:
                total += b - max(a, end)
                end = b
        return total


def rows_equal(a, b) -> bool:
    nan = lambda v: isinstance(v, float) and math.isnan(v)
    return len(a) == len(b) and all(
        all(x == y or (nan(x) and nan(y)) for x, y in zip(ra, rb)) for ra, rb in zip(a, b))


def phase_sweep(card, work: Path, ctx: dict) -> dict:
    """The corpus sweep through cli/sweep.py (raw twice, packed, fused_conv);
    returns the launches of each run and the kernel's largest error on the
    packed-decoded batch."""
    import contextlib
    import io

    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli import sweep
    from laughter_detection_icsi_tpu_torch.config import parse_float_list
    from laughter_detection_icsi_tpu_torch.data import audio, shorten
    from laughter_detection_icsi_tpu_torch.eval import analyse as an
    from laughter_detection_icsi_tpu_torch.eval import textgrid
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing
    from laughter_detection_icsi_tpu_torch.parallel import ShardedPipeline
    from laughter_detection_icsi_tpu_torch.runtime import native

    check(native.available(), "the native audio decoder did not build (g++ under the CUDA "
                              "toolkit's machine): the sweep would decode shorten in numpy")
    t0 = time.perf_counter()
    tdir, adir, paths = write_sweep_corpus(work / "corpus", ctx["cache"])
    ctx["corpus"] = (tdir, adir, paths)  # phase 10 trains on it
    metas = {m: [audio.info(p) for p in ps] for m, ps in paths.items()}
    audio_s = sum(i.duration for ms in metas.values() for i in ms)
    n_chans = sum(len(ps) for ps in paths.values())
    print(f"corpus: {len(paths)} meetings, {n_chans} channels, {audio_s:.3f} audio-s "
          f"({audio_s / 60:.2f} min), written in {time.perf_counter() - t0:.1f} s")
    thresholds = parse_float_list(sweep.DEFAULT_THRESHOLDS)
    min_lengths = parse_float_list(sweep.DEFAULT_MIN_LENGTHS)
    grid = len(thresholds) * len(min_lengths)
    settings = inference.settings_from_flags(device="cuda", precision="float32")
    n_batches = {m: -(-max(host_prep.num_frames(i.num_samples) for i in ms) // settings.bucket_frames)
                 for m, ms in metas.items()}
    n_warm = len({len(ps) for ps in paths.values()})  # one warm-up per channel count
    shortened = [m for m, _, _, enc in SWEEP_CORPUS if enc == "shorten"]
    n_shorten = sum(len(paths[m]) for m in shortened)
    spans = HostSpans()
    spans.wrap(native, "decode_shorten")
    spans.wrap(shorten, "decode_file")  # the numpy decoder: must not run
    spans.wrap(textgrid, "write_textgrid")

    def run(name: str, *flags, only=()) -> dict:
        out = work / f"sweep_{name}"
        spans.spans.clear()
        audio._SHORTEN_CACHE.clear()  # every run decodes the shorten files anew
        text = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        native_before = native.shorten_decodes
        fbank_cuda.launches = 0
        path = "sweep" if name == "raw" else f"sweep_{name}"
        with contextlib.redirect_stdout(text), EPILOGUES.count(path):
            rc = sweep.main(["--audio_dir", str(adir), "--transcript_dir", str(tdir),
                             "--output_dir", str(out), "--split", "all", "--analyse",
                             "--model_path", ctx["ckpt"], "--device", "cuda",
                             "--precision", "float32", *flags])
        torch.cuda.synchronize()
        launches = fbank_cuda.launches
        check(rc == 0, f"sweep {name} returned {rc}")
        text = text.getvalue()
        decoded = native.shorten_decodes - native_before
        want_decodes = sum(len(paths[m]) for m in shortened if not only or m in only)
        check(decoded == want_decodes and not spans.spans.get("decode_file"),
              f"sweep {name}: the native decoder decoded {decoded} of {want_decodes} shorten "
              f"channels, the numpy one {len(spans.spans.get('decode_file', []))}")
        check("audio decoder: native C++" in text, f"sweep {name}: no native decoder line")
        got = re.search(r"swept ([\d.]+) h of audio \(([\d.]+) audio-s\) in ([\d.]+) s: "
                        r"([\d.]+) audio-s per wall-s end to end, ([\d.]+) inference only", text)
        check(got is not None, f"sweep {name}: no summary line in {text[-500:]}")
        wall = float(got[3])
        res = dict(out=out / "all", launches=launches, hours=float(got[1]), wall=wall,
                   e2e=float(got[4]), inference=float(got[5]),
                   peak=torch.cuda.max_memory_allocated(),
                   decode_s=spans.covered("decode_shorten"), n_decodes=decoded,
                   tg_s=spans.covered("write_textgrid"), n_tg=len(spans.spans.get("write_textgrid", [])))
        report = [line for line in text.splitlines() if line.startswith(("swept", "best F1", "AP("))]
        print(f"sweep {name} ({' '.join(flags) or 'raw'}): {launches} fbank launches, "
              f"{EPILOGUES.by_path[path]} conv epilogue launches; " + "; ".join(report))
        return res

    try:
        raw = run("raw")
        # One launch per bucket batch of every meeting, and one per channel
        # count warmed before the clock starts.
        want = n_warm + sum(n_batches.values())
        check(raw["launches"] == want, f"sweep: {raw['launches']} fbank launches for "
              f"{sum(n_batches.values())} bucket batches {n_batches} + {n_warm} warm-ups")
        ctx["sweep_launches"] = want  # the bf16 sweep runs the same buckets
        spipe = ShardedPipeline(ctx["model"], settings=settings, device="cuda")
        for m, ps in paths.items():
            probs, durations = spipe.probs_for_meeting(ps)
            for c, (p, dur) in enumerate(zip(probs, durations)):
                check_probs(p, (host_prep.num_frames(metas[m][c].num_samples),), f"sweep {m}/chan{c}")
                want_inst = smoothing.instances_from_device_probs(
                    torch.from_numpy(p).cuda(), thresholds, min_lengths, fps=len(p) / dur)
                grids = sorted(raw["out"].glob(f"{m}/t_*/l_*/chan{c}.TextGrid"))
                check(len(grids) == grid, f"{m}/chan{c}: {len(grids)} TextGrids, not {grid}")
                for (thr, ml), inst in want_inst.items():
                    g = raw["out"] / m / f"t_{thr}" / f"l_{ml}" / f"chan{c}.TextGrid"
                    check(textgrid.read_laughter_intervals(str(g)) == inst,
                          f"{g}: TextGrid differs from the smoothing of probs_for_meeting")
        print(f"sweep: {grid} TextGrids per channel x {n_chans} channels, each equal to the "
              f"smoothing of ShardedPipeline.probs_for_meeting; fbank launched {raw['launches']} "
              f"times = {sum(n_batches.values())} bucket batches {n_batches} + {n_warm} warm-ups")
        rows = an.read_csv(raw["out"].parent / "all_sum_stats.csv", an.SumStats)
        check(len(rows) == grid and all(math.isfinite(r.precision) for r in rows),
              f"sum stats: {len(rows)} rows, finite precision {all(math.isfinite(r.precision) for r in rows)}")
        evals = an.read_csv(raw["out"].parent / "all_eval_df_per_meeting.csv", an.EvalRow)
        check(len(evals) == grid * len(paths), f"{len(evals)} evaluation rows")
        with contextlib.redirect_stdout(io.StringIO()):  # a progress line per directory
            fresh = an.analyse(str(raw["out"]), transcript_dir=str(tdir), force=True)
            cached = an.analyse(str(raw["out"]), transcript_dir=str(tdir))
        check(rows_equal(fresh, rows) and rows_equal(cached, rows),
              "analyse: a recomputation or the cached read differs from the sweep's sum stats")
        best = max((r for r in rows if not math.isnan(r.f1)), key=lambda r: r.f1)
        print(f"sum stats: {len(rows)} rows, precision finite; {len(evals)} per-meeting rows; "
              f"analyse(force=True) and analyse(force=False) give the same rows; best F1 "
              f"{best.f1:.4f} at threshold {best.threshold}, min_len {best.min_len} "
              f"(recall {best.recall:.4f})")
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("pandas", "lxml"))
        check(not loaded, f"the sweep loaded {loaded}")
        print("pandas and lxml are not loaded")

        again = run("raw_again")
        best_e2e = max(raw["e2e"], again["e2e"])
        best_inf = max(raw["inference"], again["inference"])
        print(f"sweep on {card}: {raw['hours']:.4f} h of audio; end to end (the sweep loop: "
              f"decode, inference, smoothing, TextGrids) {raw['e2e']:.2f}, {again['e2e']:.2f} "
              f"audio-s per wall-s (best of 2: {best_e2e:.2f}); inference only {raw['inference']:.2f}, "
              f"{again['inference']:.2f} (best {best_inf:.2f}); peak device memory "
              f"{raw['peak'] / 2**30:.3f} / {again['peak'] / 2**30:.3f} GiB")
        shorten_s = sum(i.duration for m in shortened for i in metas[m])
        print(f"every shorten channel ({n_shorten}, {shorten_s:.0f} audio-s) went through the "
              f"native decoder in each run, none through the numpy one")
        for r, name in ((raw, "first"), (again, "second")):
            print(f"  {name} run, host shares of the loop's {r['wall']:.3f} s: native shorten decode "
                  f"{r['decode_s']:.3f} s = {100 * r['decode_s'] / r['wall']:.1f}% "
                  f"({r['n_decodes']} files, {shorten_s:.0f} audio-s); "
                  f"TextGrid writes {r['tg_s']:.3f} s = {100 * r['tg_s'] / r['wall']:.1f}% "
                  f"({r['n_tg']} files)")
            # All of ICSI is shorten: the same loop with every channel
            # decoded at this run's decode rate (audio-s per second of wall
            # that a decode covers), the rest of the loop as measured.
            rate = shorten_s / r["decode_s"]
            est = audio_s / (r["wall"] - r["decode_s"] + audio_s / rate)
            print(f"  expected on an all-shorten corpus of the same {audio_s:.0f} audio-s: "
                  f"{est:.2f} audio-s per wall-s end to end (decode at {rate:.3f} audio-s per "
                  f"decode-s, {audio_s / rate:.1f} s of decode)")
        alone = run("shorten_meeting", "--meetings", SHORTEN_MEETING, only=(SHORTEN_MEETING,))
        check(alone["launches"] == 1 + n_batches[SHORTEN_MEETING],
              f"{SHORTEN_MEETING} sweep: {alone['launches']} launches")
        print(f"sweep of {SHORTEN_MEETING} alone ({len(paths[SHORTEN_MEETING])} x "
              f"{metas[SHORTEN_MEETING][0].duration:.0f} s in shorten SPHERE, ICSI's encoding) on "
              f"{card}: {alone['e2e']:.2f} audio-s per wall-s end to end, {alone['inference']:.2f} "
              f"inference only; native decode {alone['decode_s']:.3f} s = "
              f"{100 * alone['decode_s'] / alone['wall']:.1f}% of its {alone['wall']:.3f} s loop")

        packed = run("packed", "--transfer_codec", "packed")
        check(packed["launches"] == raw["launches"], f"packed sweep: {packed['launches']} launches")
        a = sorted(p.relative_to(raw["out"]) for p in raw["out"].rglob("*.TextGrid"))
        b = sorted(p.relative_to(packed["out"]) for p in packed["out"].rglob("*.TextGrid"))
        check(a == b and all((raw["out"] / p).read_bytes() == (packed["out"] / p).read_bytes()
                             for p in a), "the packed sweep's TextGrids differ from raw")
        print(f"packed sweep: its {len(a)} TextGrids equal raw's byte for byte; {packed['e2e']:.2f} "
              f"audio-s per wall-s end to end, {packed['inference']:.2f} inference only")
        max_err = packed_bucket(card, spipe, ctx, paths["Bmr021"])

        fused = run("fused_conv", "--mode", "fused_conv")
        check(fused["launches"] == n_warm + len(paths),
              f"fused_conv sweep: {fused['launches']} launches for {len(paths)} meetings + {n_warm} warm-ups")
        for m, ps in paths.items():
            for c in range(len(ps)):
                n = len(list(fused["out"].glob(f"{m}/t_*/l_*/chan{c}.TextGrid")))
                check(n == grid, f"fused_conv {m}/chan{c}: {n} TextGrids")
        print(f"fused_conv sweep: {fused['launches']} launches ({len(paths)} meetings + {n_warm} "
              f"warm-ups); {fused['e2e']:.2f} audio-s per wall-s end to end, "
              f"{fused['inference']:.2f} inference only; peak {fused['peak'] / 2**30:.3f} GiB")
    finally:
        spans.restore()

    ps = paths["Bns001"]
    took = []
    for _ in range(2):
        t0 = time.perf_counter()
        spipe.probs_for_meeting(ps)
        took.append(time.perf_counter() - t0)
    device_breakdown(f"probs_for_meeting (Bns001, {len(ps)} x {SWEEP_CORPUS[1][2]} s)",
                     lambda: spipe.probs_for_meeting(ps), min(took), work / "sweep.trace.json")
    return dict(launches=raw["launches"], packed=packed["launches"], fused=fused["launches"],
                max_err=max_err)


def packed_bucket(card, spipe, ctx, paths) -> float:
    """The packed codec on two [C, bucket] batches: a meeting's first
    bucket batch (``speechlike`` audio, whose wire is larger than raw) and
    one of ``closetalk`` channels, which must pack below 0.9 of raw (what
    'auto' asks).  For each: the probabilities bit-equal to raw, the
    decoded wave equal to the raw upload, the kernel within TOL of its
    plain version on it; the wire ratio and the pack, upload and decode
    times.  Returns the kernel's largest error."""
    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.data import audio
    from laughter_detection_icsi_tpu_torch.parallel import ShardedPipeline

    ppipe = ShardedPipeline(ctx["model"], device="cuda", settings=inference.settings_from_flags(
        device="cuda", precision="float32", transfer_codec="packed"))
    padded, ts = zip(*(host_prep.host_pad_waveform(audio.read_int16(p)[0]) for p in paths))
    meeting, valid, _ = next(spipe.bucket_batches(padded, ts, int16_in=True))
    talk = np.stack([closetalk(spipe.wave_len, seed=200 + c) for c in range(len(paths))])
    return max(packed_batch(card, spipe, ppipe, what, batch, valid)
               for what, batch in (("Bmr021's first", meeting), ("close-talk", talk)))


def packed_batch(card, spipe, ppipe, what: str, batch, valid) -> float:
    """One bucket batch through the packed codec (see ``packed_bucket``);
    returns the kernel's largest error on the decoded batch."""
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.config import FEAT
    from laughter_detection_icsi_tpu_torch.ops import fbank as fbank_ops
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, pcm_pack

    from laughter_detection_icsi_tpu_torch.runtime import native

    check(native._load("pcmpack") is not None, "the native PCM packer did not build")
    check(torch.equal(spipe._bucket_probs_batch(batch, valid), ppipe._bucket_probs_batch(batch, valid)),
          f"{what} packed bucket batch's probabilities differ from raw")
    pack_s, numpy_s = [], []
    for _ in range(3):  # the pipeline's pack: the native packer, rows in threads
        t0 = time.perf_counter()
        wires, deltas = ppipe._maybe_pack(batch)
        pack_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        numpy_packs = [pcm_pack.pack_pcm(row, use_native=False) for row in batch]
        numpy_s.append(time.perf_counter() - t0)
    native_packs = [pcm_pack.pack_pcm(row) for row in batch]
    check(all(np.array_equal(a.words, b.words) and np.array_equal(a.widths, b.widths)
              for a, b in zip(native_packs, numpy_packs)),
          f"{what}: the native packer's words differ from the numpy packer's")
    ratio = wires.nbytes / batch.nbytes
    if what == "close-talk":
        check(ratio <= 0.9, f"the close-talk batch packs to {ratio:.4f} of raw, not <= 0.9")
    n, nb = batch.shape[1], pcm_pack.block_count(batch.shape[1])
    dev = spipe.device
    snip = host_prep.snip_cfg(FEAT)
    with torch.inference_mode(), inference.strict_fp32():
        wave = inference.upload_packed(wires, n, deltas, dev)
        check(torch.equal(wave, inference.upload_wave(batch, dev)),
              f"the packed-decoded {what} batch differs from the raw upload")
        got, want = fbank_cuda.fbank_cuda(wave, snip), fbank_ops.fbank(wave, snip)
        torch.cuda.synchronize()
        try:
            torch.testing.assert_close(got, want, **TOL)
        except AssertionError as e:
            raise PhaseError(f"kernel on the packed-decoded {what} batch disagrees with the plain "
                             f"version: {e}")
        err = (got - want).abs().max().item()
        up = {}
        for kind, host in (("raw int16", torch.from_numpy(batch)), ("packed wire", pcm_pack.wire_tensor(wires))):
            best = math.inf
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                host.to(dev)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            up[kind] = best
        dev_wire = pcm_pack.widen(pcm_pack.wire_tensor(wires).to(dev))
        decode = lambda: [pcm_pack.unpack_pcm(words, widths, n, d) for (widths, words), d
                          in zip((pcm_pack.split_wire(r, nb) for r in dev_wire), deltas)]
        # ~30 launches a row: time a few calls, or the launch queue fills
        # while the device waits and the host cannot queue ahead of it.
        decode_ms = cuda_ms(decode, iters=3)
        decode_host = math.inf
        for _ in range(5):
            t0 = time.perf_counter()
            decode()
            torch.cuda.synchronize()
            decode_host = min(decode_host, time.perf_counter() - t0)
    print(f"packed [{batch.shape[0]}, {n}] {what} bucket batch on {card}: probabilities bit-equal "
          f"to raw; the decoded wave equals the raw upload; kernel vs plain max |diff| {err:.3e} "
          f"(atol {TOL['atol']}, rtol {TOL['rtol']})")
    print(f"  wire {wires.nbytes} B for {batch.nbytes} B raw = {ratio:.4f} (rows in delta mode: "
          f"{sum(deltas)} of {len(deltas)}); native pack {1e3 * min(pack_s):.3f} ms (host, best of 3, "
          f"{batch.shape[0]} rows in threads; the numpy packer, rows one after another: "
          f"{1e3 * min(numpy_s):.2f} ms, the same words); upload raw {1e3 * up['raw int16']:.3f} ms vs wire "
          f"{1e3 * up['packed wire']:.3f} ms (host clock, pageable, best of 5); decode "
          f"{decode_ms:.3f} ms on the device (CUDA events), {1e3 * decode_host:.3f} ms on the host "
          f"clock (launch-bound; best of 5)")
    return err


def phase_train(card, work: Path, ctx: dict) -> int:
    """Training at full width on the card (see the module docstring, phase
    9); returns the fbank launches that featurized its inputs."""
    import signal

    import torch

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.cli import segment_laughter as cli
    from laughter_detection_icsi_tpu_torch.config import FEAT, MODEL_MAP
    from laughter_detection_icsi_tpu_torch.eval import textgrid
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing
    from laughter_detection_icsi_tpu_torch.train import Adam, TrainLoop, Trainer, step_generator

    preset = MODEL_MAP["resnet_base"]
    weights = {k: v.detach().cpu() for k, v in ctx["model"].state_dict().items()}

    def model(dropout: float):
        m = zoo.build(preset.model, dropout_rate=dropout, linear_layer_size=preset.linear_layer_size,
                      filter_sizes=preset.filter_sizes)
        m.load_state_dict(weights, strict=True)
        return m

    fbank_cuda.launches = 0
    with torch.no_grad(), inference.strict_fp32():
        feats = fbank_cuda.fbank_cuda(torch.from_numpy(ctx["pcm"]).to(DEVICE).float() / 32768.0, FEAT)
    launches = fbank_cuda.launches
    check(launches == 1, f"training features: {launches} fbank launches")
    rng = np.random.default_rng(9)
    window = torch.arange(100, device=DEVICE)

    def batch(b: int) -> dict:
        starts = torch.from_numpy(rng.integers(0, feats.shape[0] - 100, b)).to(DEVICE)
        return {"inputs": feats[starts[:, None] + window],
                "is_laugh": (rng.uniform(size=b) > 0.5).astype(np.float32)}

    with inference.strict_fp32():  # what Trainer's steps run under
        precision = precision_setting()
    print(f"resnet_base ResNetBigger {preset.filter_sizes}, head {preset.linear_layer_size}, "
          f"batch {preset.batch_size}; windows of {feats.shape[0]} fbank_cuda frames of phase 4's "
          f"audio, numpy-seeded labels; {precision} inside the steps")

    # (a) One step at dropout 0: the card against the port on the CPU.
    b0 = batch(preset.batch_size)
    card_t, cpu_t = Trainer(model(0.0), device=DEVICE), Trainer(model(0.0), device="cpu")
    x, y = card_t._prep(b0)
    loss_c, probs_c, g_c = card_t.loss_and_grads(x, y)
    x_h, y_h = cpu_t._prep({"inputs": b0["inputs"].cpu(), "is_laugh": b0["is_laugh"]})
    loss_h, _, g_h = cpu_t.loss_and_grads(x_h, y_h)
    d_loss = abs(loss_c.item() - loss_h.item())
    check(d_loss <= 1e-5, f"train step: card loss {loss_c.item():.6f} vs CPU {loss_h.item():.6f}")
    rel = {k: ((g_c[k].cpu() - g_h[k]).abs().max() / max(1.0, g_h[k].abs().max().item())).item()
           for k in g_h}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= 1e-4, f"train step: gradient of {worst} off by {rel[worst]:.3e} of "
                              "max(1, its max |g|) from the CPU's")
    before = {k: p.detach().cpu().clone() for k, p in card_t.params.items()}
    card_t.optimizer.update(g_c, card_t.init(), card_t.params)
    cpu_adam = Adam()
    cpu_adam.update({k: g.cpu() for k, g in g_c.items()}, cpu_adam.init(before), before)
    d_upd = max((card_t.params[k].detach().cpu() - before[k]).abs().max().item() for k in before)
    check(d_upd <= 1e-6, f"train step: the card's Adam update is {d_upd:.3e} from the CPU's")
    print(f"(a) one step, dropout 0, B={preset.batch_size}: loss card {loss_c.item():.6f} vs CPU "
          f"{loss_h.item():.6f} (|diff| {d_loss:.3e}, limit 1e-5); probs in "
          f"[{probs_c.min().item():.4f}, {probs_c.max().item():.4f}]; gradients: worst leaf "
          f"{worst} {rel[worst]:.3e} of max(1, max |g|) (limit 1e-4); the card's Adam update vs "
          f"the CPU's Adam on the card's gradients {d_upd:.3e} (limit 1e-6)")

    # (b) 20 steps at dropout 0.5 on one batch.
    t = Trainer(model(0.5), device=DEVICE)
    opt, losses = t.init(), []
    with EPILOGUES.count("train_steps"):  # train mode's batch statistics: owes 0
        for step in range(20):
            opt, m = t.train_batch(opt, b0, step_generator(0, step, DEVICE))
            losses.append(m["loss"])
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"20 steps on one batch: losses {losses[0]:.4f} ... {losses[-1]:.4f}")
    print(f"(b) 20 steps, dropout 0.5, one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(min {losses.min():.4f})")

    # (c) TrainLoop: checkpoint, SIGTERM at a step boundary, resume.
    batches = [batch(preset.batch_size) for _ in range(10)]
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, signal.getsignal(signal.SIGTERM),
             signal.getsignal(signal.SIGINT))
    cudnn.deterministic, cudnn.benchmark = True, False  # the two runs take the same algorithms
    try:
        ref = Trainer(model(0.5), device=DEVICE)
        ref_loop = TrainLoop(trainer=ref, checkpoint_dir=str(work / "train_ref"), log_frequency=3)
        ref_loop.run_epoch(ref.init(), batches, seed=7, verbose=False)

        def signalled():
            for i, b in enumerate(batches):
                if i == 4:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b

        t = Trainer(model(0.5), device=DEVICE)
        loop = TrainLoop(trainer=t, checkpoint_dir=str(work / "train"), log_frequency=3)
        loop.install_preemption_handler()
        loop.run_epoch(t.init(), signalled(), seed=7, verbose=False)
        check(loop.preempted and (loop.global_step, loop.epoch_step) == (5, 5),
              f"SIGTERM: stopped at step {loop.global_step}, epoch_step {loop.epoch_step}")
        t2 = Trainer(model(0.5), device=DEVICE)
        loop2 = TrainLoop(trainer=t2, checkpoint_dir=str(work / "train"), log_frequency=3)
        opt2 = loop2.resume_if_possible(t2.init())
        restored = (loop2.global_step, loop2.epoch, loop2.epoch_step, int(opt2.step))
        check(restored == (5, 0, 5, 5), f"resume restored (global_step, epoch, epoch_step, "
                                        f"Adam step) = {restored}")
        opt2, _ = loop2.run_epoch(opt2, batches, seed=7, verbose=False)
        loop2.save(opt2)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[:2]
        signal.signal(signal.SIGTERM, saved[2])
        signal.signal(signal.SIGINT, saved[3])
    want = ref.model.state_dict()
    d_resume = max((v.float() - want[k].float()).abs().max().item()
                   for k, v in t2.model.state_dict().items())
    check(d_resume <= 1e-4, f"resumed run {d_resume:.3e} from the uninterrupted one")
    print(f"(c) TrainLoop, 10 steps, dropout 0.5, log_frequency 3: SIGTERM before batch 5 -> "
          f"checkpoint at step 5, resume restored (global_step, epoch, epoch_step, Adam step) "
          f"{restored}; resumed vs uninterrupted max |diff| {d_resume:.3e} (limit 1e-4; "
          f"cuDNN deterministic)")

    # (d) The trained checkpoint through the segment CLI.
    ckpt = str(work / "train" / "last.ckpt.npz")
    trained = model(0.0)
    trained.load_state_dict(t2.model.state_dict())
    pipe = inference.LaughterPipeline(
        trained, device=DEVICE,
        settings=inference.settings_from_flags(device=DEVICE, precision="float32"))
    probs, _ = pipe.probs_for_file(str(ctx["wav"]))
    check_probs(probs, ctx["probs"].shape, "trained checkpoint")
    thr = midway_threshold(probs)
    out = work / "out_trained"
    rc = cli.main(["--model_path", ckpt, "--input_audio_file", str(ctx["wav"]),
                   "--output_dir", str(out), "--thresholds", f"{thr}", "--min_lengths", "0.2",
                   "--save_to_textgrid", "True", "--save_to_audio_files", "False",
                   "--device", DEVICE, "--precision", "float32"])
    check(rc == 0, f"segment CLI on the trained checkpoint returned {rc}")
    got = textgrid.read_laughter_intervals(str(out / f"t_{thr}" / "l_0.2" / "meeting.TextGrid"))
    want_i = smoothing.get_laughter_instances(probs, [thr], [0.2])[(thr, 0.2)]
    check(got == want_i, "the trained checkpoint's TextGrid differs from LaughterPipeline's")
    print(f"(d) the trained checkpoint through cli/segment_laughter --device cuda: probabilities "
          f"finite in [{probs.min():.4f}, {probs.max():.4f}]; {len(got)} instances at threshold "
          f"{thr}, equal to the smoothing of LaughterPipeline with those weights")

    # (e) Steps per second, peak memory, where one step's device time goes.
    for b in TRAIN_SIZES:
        t = Trainer(model(0.5), device=DEVICE)
        opt = t.init()
        bb = batch(b)
        n_steps = 50 if b <= 64 else 20  # 20 of ~0.28 s at B = 1024 keep the run short
        gens = [step_generator(1, s, DEVICE) for s in range(n_steps)]
        for s in range(3):
            opt, _ = t.train_batch(opt, bb, gens[s])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def timed():
            """(device ms, host ms) a step over n_steps steps."""
            nonlocal opt
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for s in range(n_steps):
                opt, _ = t.train_batch(opt, bb, gens[s])
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n_steps, 1e3 * (time.perf_counter() - t0) / n_steps

        ms = [timed() for _ in range(3)]
        best = min(ms)
        peak = torch.cuda.max_memory_allocated()
        print(f"(e) B={b} on {card}: {1e3 / best[0]:.2f} train steps per second (best of 3 x {n_steps}: "
              f"{', '.join(f'{d:.3f}' for d, _ in ms)} ms a step between CUDA events; host clock "
              f"{best[1]:.3f} ms); {b * 1e3 / best[0]:.0f} windows per second; peak device memory "
              f"{peak / 2**30:.3f} GiB")
        if b == TRAIN_SIZES[0]:
            # What cli/train's cuDNN flags (deterministic, no autotuning)
            # cost at the preset's batch:
            # in turns with the flags as they are (A B B A B A), best of 3
            # each, as the host-bound rate drifts over a run.
            from laughter_detection_icsi_tpu_torch.cli.train import CUDNN_FLAGS, cudnn_flags

            now = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
            with cudnn_flags(CUDNN_FLAGS):
                timed()  # warm under the flags
            turns = {True: [], False: []}
            for det in (True, False, False, True, True, False):
                with cudnn_flags(CUDNN_FLAGS if det else None):
                    turns[det].append(timed()[0])
            on, off = min(turns[True]), min(turns[False])
            print(f"    cli/train's cuDNN flags (deterministic {CUDNN_FLAGS[0]}, benchmark "
                  f"{CUDNN_FLAGS[1]}) in turns with (deterministic {now[0]}, benchmark {now[1]}), "
                  f"best of 3 x {n_steps} each: {1e3 / on:.2f} against {1e3 / off:.2f} steps per "
                  f"second ({', '.join(f'{d:.3f}' for d in turns[True])} against "
                  f"{', '.join(f'{d:.3f}' for d in turns[False])} ms a step): "
                  f"{100 * (1 - off / on):.1f}% fewer")
        train_breakdown(f"B={b}", lambda: t.train_batch(opt, bb, gens[0]), work / f"train_{b}.trace.json")
        ctx.setdefault("train_rate", {})[b] = 1e3 / best[0]
    return launches


#: Phase 10's tables: laugh and non-laugh samples per laugh (structured mode).
#: Bro012's 74 laughs give a train split of 14,800 rows (cut from 200 + 200
#: to keep the script's time: the log point at step 900 went with them).
#: The CLI runs train on every other row, 7,400 rows = 232 steps of the
#: preset's batch of 32 an epoch (the same cut again: cli/train's B = 32
#: epochs are host-bound); phase 14 takes its rows from the whole table.
CORPUS_SAMPLES = (100, 100)
MIN_TRAIN_ROWS = 8_000


def phase_corpus_train(card, work: Path, ctx: dict) -> dict:
    """Training from a corpus through the three CLIs (see the module
    docstring, phase 10); returns compute_features's fbank launches and the
    cached track's largest error against the plain featurizer."""
    import contextlib
    import io
    import itertools
    import signal

    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli import compute_features, create_data_df
    from laughter_detection_icsi_tpu_torch.cli import segment_laughter as seg_cli
    from laughter_detection_icsi_tpu_torch.cli import train as train_cli
    from laughter_detection_icsi_tpu_torch.config import (
        FEAT, MODEL_MAP, PARTITIONS, split_of_meeting)
    from laughter_detection_icsi_tpu_torch.data import (
        FeatureCache, LadDataset, ResidentLadDataset, load_split_df, write_data_dfs)
    from laughter_detection_icsi_tpu_torch.data.dataset import _epoch_slices
    from laughter_detection_icsi_tpu_torch.eval import textgrid
    from laughter_detection_icsi_tpu_torch.eval import transcript as transcript_lib
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.ops import fbank as fbank_ops
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing
    from laughter_detection_icsi_tpu_torch.runtime import native
    from laughter_detection_icsi_tpu_torch.train import Trainer
    from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib

    tdir, adir, paths = ctx["corpus"]
    root = work / "train_data"
    dfs, feats = root / "data_dfs", root / "feats"
    ctx["train_data"] = (root, dfs, feats, adir)  # phase 14 trains on them
    preset = MODEL_MAP["resnet_base"]

    def cli(main, argv):
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = main(argv)
        check(rc == 0, f"{main.__module__} returned {rc}: {text.getvalue()[-800:]}")
        return text.getvalue(), time.perf_counter() - t0

    # (a) The tables.
    n_laugh, n_non = CORPUS_SAMPLES
    out, took = cli(create_data_df.main, ["--transcript_dir", str(tdir), "--data_dfs_dir", str(dfs),
                                          "--num_laugh_samples", str(n_laugh),
                                          "--num_non_laugh_samples", str(n_non)])
    tables = {split: load_split_df(str(dfs), split) for split in PARTITIONS}
    store = transcript_lib.TranscriptStore(str(tdir))
    laughs = {split: sum(1 for s in store.laugh_only if split_of_meeting(s.meeting_id) == split)
              for split in PARTITIONS}
    kinds = {"speech": {(s.meeting_id, s.chan_id, s.start, s.length) for s in store.speech},
             "noise": {(s.meeting_id, s.chan_id, s.start, s.length) for s in store.noise}}
    silence_n, noise_n = math.floor(n_non * 0.7), math.floor(n_non * 0.1)
    want_mix = {"silence": silence_n, "noise": noise_n, "speech": n_non - silence_n - noise_n}
    for split, rows in tables.items():
        meetings = {r["meeting_id"] for r in rows}
        check(bool(meetings) and meetings <= set(PARTITIONS[split]),
              f"{split}: meetings {sorted(meetings)} not all its own")
        check(all(r["audio_path"].split("/")[0] == r["meeting_id"] for r in rows),
              f"{split}: an audio_path names another meeting")
        got_mix = {"silence": 0, "noise": 0, "speech": 0}
        for r in rows:
            if r["label"] == 0:
                key = (r["meeting_id"], r["chan_id"], r["start"], r["duration"])
                got_mix[next((k for k, v in kinds.items() if key in v), "silence")] += 1
        check(got_mix == {k: v * laughs[split] for k, v in want_mix.items()}
              and sum(r["label"] == 1 for r in rows) == n_laugh * laughs[split],
              f"{split}: mix {got_mix} for {laughs[split]} laughs, want {want_mix} each")
    n_train = len(tables["train"])
    check(n_train >= MIN_TRAIN_ROWS, f"train split {n_train} rows < {MIN_TRAIN_ROWS}")
    print(f"(a) cli/create_data_df, {n_laugh} laugh + {n_non} non-laugh samples a laugh, in "
          f"{took:.2f} s: " + ", ".join(f"{s} {len(r)} rows ({laughs[s]} laughs; meetings "
                                       f"{sorted({x['meeting_id'] for x in r})})"
                                       for s, r in tables.items())
          + f"; every split's non-laugh mix is {want_mix['silence']}/{want_mix['noise']}/"
          f"{want_mix['speech']} silence/noise/speech a laugh (70/10/20), every meeting its split's")

    # (b) Features: one launch a 30,000-frame bucket of every track.
    argv = ["--audio_dir", str(adir), "--transcript_dir", str(tdir), "--output_dir", str(feats),
            "--device", DEVICE]
    metas = {(m, f"chan{c}"): native.info(p) for m, ps in paths.items() for c, p in enumerate(ps)}
    buckets = sum(-(-host_prep.num_frames(i.num_samples) // 30000) for i in metas.values())
    fbank_cuda.launches = 0
    out, took = cli(compute_features.main, argv)
    launches = fbank_cuda.launches
    check(f"done: {len(metas)} featurized, 0 cached, 0 missing" in out, f"compute_features: {out[-300:]}")
    check(launches == buckets, f"compute_features: {launches} fbank launches for {buckets} buckets")
    audio_s = sum(i.duration for i in metas.values())
    print(f"(b) cli/compute_features --device {DEVICE}: {len(metas)} tracks, {audio_s:.0f} audio-s, "
          f"in {took:.2f} s ({audio_s / took:.0f} audio-s per s, decode included); fbank launched "
          f"{launches} times = the tracks' {buckets} buckets of 30,000 frames")
    cache = FeatureCache(str(feats))
    m, c = "Bmr021", "chan3"  # two buckets, the second partial; 777 samples short
    wave, _ = native.read(paths[m][3])
    padded, t = host_prep.host_pad_waveform(wave, FEAT)
    with torch.no_grad(), inference.strict_fp32():
        plain = fbank_ops.fbank(torch.from_numpy(padded.astype(np.float32)).to(DEVICE),
                                host_prep.snip_cfg(FEAT)).cpu().numpy()
    cached = np.asarray(cache.track(m, c))
    check(cached.shape == plain.shape == (t, FEAT.num_filters), f"{m}/{c}: {cached.shape} vs {plain.shape}")
    err = np.abs(cached - plain)
    check(bool(np.all(err <= TOL["atol"] + TOL["rtol"] * np.abs(plain))),
          f"{m}/{c}: cached features {err.max():.3e} from the plain featurizer")
    print(f"    cached {m}/{c} ({t} frames) vs the plain featurizer on the same PCM on {DEVICE}: "
          f"max |diff| {err.max():.3e} (atol 2e-4, rtol 1e-4)")
    fbank_cuda.launches = 0
    out, _ = cli(compute_features.main, argv)
    check(f"done: 0 featurized, {len(metas)} cached, 0 missing" in out and fbank_cuda.launches == 0,
          f"second compute_features: {out[-200:]}, {fbank_cuda.launches} launches")
    print(f"    a second run featurized nothing ({len(metas)} cached, 0 launches)")

    # (c)-(f) and phase 12's bf16 epoch train on every other row of the
    # train table (see CORPUS_SAMPLES); phase 14 keeps the whole table.
    dfs = root / "data_dfs_cli"
    write_data_dfs({**tables, "train": tables["train"][::2]}, str(dfs))
    n_cli = len(tables["train"][::2])
    ctx["train_data_cli"] = (root, dfs, feats, adir)

    # (c) One epoch three ways, (d) SIGTERM mid-epoch and resume.
    base = ["--config", "resnet_base", "--data_root", str(root), "--data_dfs_dir", str(dfs),
            "--feats_dir", str(feats), "--signals_dir", str(adir), "--device", DEVICE,
            "--seed", "3"]
    # No cuDNN flags are set here: cli/train takes the deterministic mode on
    # the card itself, which is what makes the runs below equal.
    saved = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    real_step = Trainer.train_batch
    steps = -(-n_cli // preset.batch_size)
    cut_at = min(400, steps // 2)
    runs = {}
    try:
        for name, flags in (("streamed", ["--device_cache", "off"]),
                            ("resident", ["--device_cache", "on"]),
                            ("resident_k4", ["--device_cache", "on", "--steps_per_dispatch", "4"])):
            fbank_cuda.launches = 0
            out, took = cli(train_cli.main, base + ["--checkpoint_dir", str(root / name), *flags])
            check(fbank_cuda.launches == 0, f"train {name}: featurized again")
            resident = re.search(r"device cache: (\d+) train windows resident", out)
            check((resident is not None) == (name != "streamed")
                  and (resident is None or int(resident[1]) == n_cli),
                  f"train {name}: resident line {resident and resident[0]}")
            runs[name] = (ckpt_lib.load_checkpoint(str(root / name / "last.ckpt.npz")), took, out)
        calls = []

        def signalling(self, *a, **kw):
            calls.append(1)
            if len(calls) == cut_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return real_step(self, *a, **kw)

        Trainer.train_batch = signalling
        out, cut_s = cli(train_cli.main, base + ["--checkpoint_dir", str(root / "cut"), "--device_cache", "off"])
        Trainer.train_batch = real_step
        check(f"preempted at step {cut_at}" in out, f"the SIGTERM run: {out[-300:]}")
        stopped = ckpt_lib.load_checkpoint(str(root / "cut" / "last.ckpt.npz"))
        out, resume_s = cli(train_cli.main, base + ["--checkpoint_dir", str(root / "cut"), "--device_cache", "off"])
        check(f"resumed from step {cut_at} (epoch 0)" in out, f"the resumed run: {out[-300:]}")
        runs["resumed"] = (ckpt_lib.load_checkpoint(str(root / "cut" / "last.ckpt.npz")), resume_s, out)
    finally:
        Trainer.train_batch = real_step
        signal.signal(signal.SIGTERM, saved[0])
        signal.signal(signal.SIGINT, saved[1])
    ref = runs["streamed"][0]
    log = preset.log_frequency
    val = re.search(rf"step {log}: .*val_loss=([\d.]+)", runs["streamed"][2])
    check((val is not None) == (steps >= log) and ref["global_step"] == steps and ref["epoch"] == 1,
          f"streamed run: global_step {ref['global_step']} (want {steps}), epoch {ref['epoch']}, "
          f"log line at step {log}: {val}")
    diffs = {}
    for name in ("resident", "resident_k4", "resumed"):
        got = runs[name][0]
        check((got["global_step"], got["epoch"]) == (steps, 1), f"{name}: counters")
        pairs = [(v, ref["state_dict"][k]) for k, v in got["state_dict"].items()]
        pairs += [(getattr(got["opt_state"], m)[k], getattr(ref["opt_state"], m)[k])
                  for m in ("mu", "nu") for k in ref["opt_state"].mu]
        diffs[name] = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
        check(diffs[name] <= 1e-6 and int(got["opt_state"].step) == steps,
              f"{name} checkpoint {diffs[name]:.3e} from the streamed one (weights, buffers, "
              f"Adam moments), Adam step {int(got['opt_state'].step)}")
    print(f"(c) cli/train --config resnet_base --device {DEVICE}, one epoch of {n_cli} rows = "
          f"{steps} steps of {preset.batch_size} (dropout 0.5; "
          + (f"log point at step {log}, val loss {float(val[1]):.4f}" if val else "no log point")
          + f"; cli/train's cuDNN deterministic): streamed {runs['streamed'][1]:.1f} s, "
          f"resident {runs['resident'][1]:.1f} s ({n_cli} train windows resident), resident "
          f"with --steps_per_dispatch 4 {runs['resident_k4'][1]:.1f} s; checkpoints (weights, "
          f"buffers, Adam moments) vs streamed: "
          f"resident {diffs['resident']:.3e}, K=4 {diffs['resident_k4']:.3e} (limit 1e-6)")
    print(f"(d) SIGTERM before step {cut_at + 1}: stopped at (global_step, epoch_step) "
          f"({stopped['global_step']}, {stopped['epoch_step']}) in {cut_s:.1f} s; resumed through "
          f"the CLI (skip_assembly {cut_at}) in {resume_s:.1f} s: {diffs['resumed']:.3e} from "
          f"the uninterrupted run (limit 1e-6)")

    # (e) The trained checkpoint through the segment CLI.
    ck = ckpt_lib.resolve_checkpoint(str(root / "resident"))
    trained = zoo.build(preset.model, dropout_rate=0.0, linear_layer_size=preset.linear_layer_size,
                        filter_sizes=preset.filter_sizes)
    trained.load_state_dict(ckpt_lib.load_checkpoint(ck)["state_dict"], strict=True)
    pipe = inference.LaughterPipeline(
        trained, device=DEVICE,
        settings=inference.settings_from_flags(device=DEVICE, precision="float32"))
    probs, _ = pipe.probs_for_file(str(ctx["wav"]))
    check_probs(probs, ctx["probs"].shape, "corpus-trained checkpoint")
    thr = midway_threshold(probs)
    seg_out = work / "out_corpus_trained"
    rc = seg_cli.main(["--model_path", str(root / "resident"), "--input_audio_file", str(ctx["wav"]),
                       "--output_dir", str(seg_out), "--thresholds", f"{thr}", "--min_lengths", "0.2",
                       "--save_to_textgrid", "True", "--save_to_audio_files", "False",
                       "--device", DEVICE, "--precision", "float32"])
    check(rc == 0, f"segment CLI on the corpus-trained checkpoint returned {rc}")
    got = textgrid.read_laughter_intervals(str(seg_out / f"t_{thr}" / "l_0.2" / "meeting.TextGrid"))
    check(got == smoothing.get_laughter_instances(probs, [thr], [0.2])[(thr, 0.2)],
          "the corpus-trained checkpoint's TextGrid differs from LaughterPipeline's")
    print(f"(e) {Path(ck).name} of the resident run through cli/segment_laughter --device {DEVICE}: "
          f"probabilities in [{probs.min():.4f}, {probs.max():.4f}]; {len(got)} instances at "
          f"threshold {thr}, equal to the smoothing of LaughterPipeline with those weights")

    # (f) Steps per second, streamed and resident.
    ds = LadDataset(tables["train"], cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ResidentLadDataset(ds, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    host = res.feats.cpu()
    t0 = time.perf_counter()
    res.feats.copy_(host)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    nbytes = res.feats.numel() * res.feats.element_size()
    print(f"(f) resident train split: {nbytes / 2**30:.3f} GiB of float32 features ({n_train} x "
          f"100 x 44); built in {build_s:.3f} s (host assembly and upload), the upload alone "
          f"{1e3 * upload_s:.1f} ms ({nbytes / upload_s / 1e9:.2f} GB/s, pageable host memory)")
    del host

    def model_trainer():
        m = zoo.build(preset.model, dropout_rate=0.5, linear_layer_size=preset.linear_layer_size,
                      filter_sizes=preset.filter_sizes, seed=5)
        return Trainer(m, device=DEVICE)

    for b in TRAIN_SIZES:
        n_steps = 30 if b <= 64 else 10
        order = itertools.chain.from_iterable(
            _epoch_slices(n_train, b, True, e, True) for e in itertools.count())
        idx_rows = [next(order) for _ in range(3 * n_steps + 10)]
        assemble_ms = []
        for idx in idx_rows[:10]:
            t0 = time.perf_counter()
            ds._assemble(idx)
            assemble_ms.append(1e3 * (time.perf_counter() - t0))
        print(f"(f) host assembly of one streamed batch of {b} rows (LadDataset._assemble): "
              f"{np.median(assemble_ms):.3f} ms (median of 10)")
        for name in ("streamed", "resident"):
            t = model_trainer()
            opt = t.init()
            if name == "streamed":
                it = itertools.chain.from_iterable(ds.batches(b, seed=e, drop_remainder=True)
                                                   for e in itertools.count())
                step = lambda s: t.train_batch(opt, next(it), t.generator(1, s))
            else:
                rows = iter(itertools.cycle(idx_rows))
                step = lambda s: t.train_batch_resident(opt, res, next(rows), 1, s)
            for s in range(3):
                opt, _ = step(s)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rates = []
            for _ in range(3):
                t0 = time.perf_counter()
                for s in range(n_steps):
                    opt, _ = step(s)
                torch.cuda.synchronize()
                rates.append(n_steps / (time.perf_counter() - t0))
            peak = torch.cuda.max_memory_allocated()
            busy = train_breakdown(f"{name} B={b}", lambda: step(0), work / f"corpus_{name}_{b}.trace.json")
            print(f"(f) {name} B={b} on {card}: {max(rates):.2f} train steps per second (best of 3 x "
                  f"{n_steps}, host clock: {', '.join(f'{r:.2f}' for r in rates)}); device busy "
                  + (f"{100 * busy:.1f}%" if busy is not None else "not measured")
                  + f" of 5 profiled steps; peak device memory {peak / 2**30:.3f} GiB")
            if name == "streamed":
                it = None  # stops the prefetch thread
    return dict(launches=launches, max_err=float(err.max()))


def best_wall(fn, n: int = 3):
    """(best, all) host-clock seconds of ``n`` calls of ``fn``, each ended by
    a device synchronize."""
    import torch

    took = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
    return min(took), took


def peak_of(fn) -> int:
    """Peak device memory of one call of ``fn``."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def phase_bf16_serving(card, work: Path, ctx: dict) -> dict:
    """bf16 on every serving path (the default on the card), each held
    against its float32 result of phases 4-8; returns the kernel launches of
    each path."""
    import contextlib
    import io

    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli import segment_laughter as cli
    from laughter_detection_icsi_tpu_torch.cli import serve, sweep
    from laughter_detection_icsi_tpu_torch.config import parse_float_list
    from laughter_detection_icsi_tpu_torch.eval import textgrid
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing
    from laughter_detection_icsi_tpu_torch.parallel import (
        ShardedPipeline, ShardedStreamingSession)

    model, wav, pcm, n_buckets = ctx["model"], ctx["wav"], ctx["pcm"], ctx["n_buckets"]
    settings = inference.settings_from_flags(device="cuda")
    check(settings.precision == "bfloat16", f"the card's default precision is {settings.precision}")
    pipe = inference.LaughterPipeline(model, settings=settings, device="cuda")
    check(all(p.dtype == torch.float32 for p in model.parameters())
          and pipe.model is not model, "the bf16 pipeline changed the caller's float32 model")
    with inference.precision_scope("bfloat16"):
        flags = (f"{precision_setting()}, cuda.matmul.allow_bf16_reduced_precision_reduction="
                 f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    print(f"bf16: settings_from_flags(device='cuda') -> {settings.precision}; the classifier on a "
          f"bf16 copy of the model, the featurizer in fp32; {flags} inside the bucket step")
    probs, duration = pipe.probs_for_file(str(wav))
    check_probs(probs, ctx["probs"].shape, "bf16 windows")
    d_f32 = float(np.abs(probs - ctx["probs"]).max())
    check(d_f32 <= 0.05, f"bf16 windows {d_f32:.3e} from float32 > 0.05")
    thr = midway_threshold(probs)

    # The main path through the CLI with no --precision: the card's default.
    out = work / "out_bf16"
    fbank_cuda.launches = 0
    with EPILOGUES.count("windows_bf16"):
        rc = cli.main(["--model_path", ctx["ckpt"], "--input_audio_file", str(wav),
                       "--output_dir", str(out), "--thresholds", f"{thr}", "--min_lengths", "0.2",
                       "--save_to_textgrid", "True", "--save_to_audio_files", "False",
                       "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"windows_bf16": fbank_cuda.launches}
    check(rc == 0, f"CLI (bf16 default) returned {rc}")
    check(launches["windows_bf16"] == n_buckets,
          f"bf16 CLI: {launches['windows_bf16']} launches for {n_buckets} buckets")
    want = smoothing.get_laughter_instances(probs, [thr], [0.2])[(thr, 0.2)]
    check(len(want) > 0, f"bf16: no laughter instances at threshold {thr}")
    got = textgrid.read_laughter_intervals(str(out / f"t_{thr}" / "l_0.2" / "meeting.TextGrid"))
    check(got == want, "the bf16 CLI's TextGrid differs from the smoothing")
    print(f"bf16 CLI run (no --precision): {launches['windows_bf16']} launches ({n_buckets} "
          f"buckets); TextGrid equals the smoothing ({len(got)} instances); probabilities in "
          f"[{probs.min():.4f}, {probs.max():.4f}], max |bf16 - float32| = {d_f32:.3e} (limit 0.05)")

    clip = pcm[: 16000 * 5]
    cpu_model = ctx["build_model"]()
    cpu_model.load_state_dict(model.state_dict())
    small = inference.InferenceSettings(chunk=256, bucket_frames=512, precision="bfloat16")
    d_cpu = float(np.abs(
        pipe.probs_for_waveform(clip)
        - inference.LaughterPipeline(cpu_model, settings=small, device="cpu").probs_for_waveform(clip)
    ).max())
    check(d_cpu <= 2e-2, f"bf16 card vs bf16 CPU differ by {d_cpu:.3e} > 2e-2")
    clip = pcm[: 16000 * 20]
    naive = inference.LaughterPipeline(model, device="cuda", settings=inference.settings_from_flags(
        device="cuda", shared_stem=False))
    d_stem = float(np.abs(pipe.probs_for_waveform(clip) - naive.probs_for_waveform(clip)).max())
    check(d_stem <= 2e-2, f"bf16 shared stem vs naive differ by {d_stem:.3e} > 2e-2")
    print(f"bf16 card vs bf16 on the CPU, 5 s clip: {d_cpu:.3e} (limit 2e-2); shared stem vs "
          f"naive windows, 20 s clip: {d_stem:.3e} (limit 2e-2)")

    run = lambda: pipe.segment_file(str(wav), [thr], [0.2])
    best, took = best_wall(run)
    peak = peak_of(run)
    print(f"e2e segment_file on {card}: bf16 {duration / best:.1f}x realtime (best of 3: "
          f"{', '.join(f'{t:.4f}' for t in took)} s) vs float32 {ctx['x_rt']:.1f}x (phase 4) = "
          f"{duration / best / ctx['x_rt']:.3f}x; peak device memory bf16 {peak / 2**30:.3f} GiB "
          f"vs float32 {ctx['peak'] / 2**30:.3f} GiB")
    device_breakdown("segment_file (bf16)", run, best, work / "bf16_windows.trace.json")

    # fused_conv in bf16.
    fpipe = inference.LaughterPipeline(model, device="cuda", settings=inference.settings_from_flags(
        device="cuda", mode="fused_conv"))
    fbank_cuda.launches = 0
    with EPILOGUES.count("fused_conv_bf16"):
        fprobs, _ = fpipe.probs_for_file(str(wav))
    launches["fused_conv_bf16"] = fbank_cuda.launches
    check(launches["fused_conv_bf16"] == 1, f"bf16 fused_conv: {fbank_cuda.launches} launches")
    check_probs(fprobs, ctx["probs"].shape, "bf16 fused_conv")
    d_fc = float(np.abs(fprobs - ctx["fused_probs"]).max())
    check(d_fc <= 0.05, f"bf16 fused_conv {d_fc:.3e} from float32 > 0.05")
    run = lambda: fpipe.segment_file(str(wav), [thr], [0.2])
    best, took = best_wall(run)
    peak = peak_of(run)
    print(f"fused_conv bf16: 1 launch; max |bf16 - float32| = {d_fc:.3e} (limit 0.05); "
          f"{duration / best:.1f}x realtime (best of 3: {', '.join(f'{t:.4f}' for t in took)} s) "
          f"vs float32 {ctx['fused_x_rt']:.1f}x (phase 5) = {duration / best / ctx['fused_x_rt']:.3f}x; "
          f"peak {peak / 2**30:.3f} GiB vs {ctx['fused_peak'] / 2**30:.3f} GiB")
    device_breakdown("segment_file (fused_conv, bf16)", run, best, work / "bf16_fused.trace.json")

    # serve replay with no --precision: streaming bit-equal to the bf16 offline.
    saved = work / "serve_bf16.npy"
    stdout = io.StringIO()
    fbank_cuda.launches = 0
    with contextlib.redirect_stdout(stdout), EPILOGUES.count("serve_bf16"):
        rc = serve.main(["--model_path", ctx["ckpt"], "--input", str(wav), "--threshold",
                         str(thr), "--min_length", "0.2", "--chunk_ms", "250", "--save_probs",
                         str(saved), "--device", "cuda"])
    launches["serve_bf16"] = fbank_cuda.launches
    check(rc == 0 and launches["serve_bf16"] == n_buckets + 1,
          f"bf16 serve: rc {rc}, {launches['serve_bf16']} launches")
    streamed = np.load(saved)
    check(streamed.shape == (1, len(probs)) and np.array_equal(streamed[0], probs),
          "bf16 streamed probabilities differ from the bf16 offline ones")
    fps = len(probs) / (len(pcm) / 16000)
    want = [(round(a, 3), round(b, 3)) for a, b in
            smoothing.get_laughter_instances(probs, [thr], [0.2], fps=fps)[(thr, 0.2)]]
    events = [(e["start"], e["end"]) for e in map(json.loads, stdout.getvalue().splitlines())
              if e["type"] == "event"]
    check(events == want, "bf16 serve events differ from the offline smoothing")
    print(f"serve replay, bf16 default: probabilities bit-equal to the bf16 offline ones, "
          f"{len(events)} events equal the smoothing, {launches['serve_bf16']} launches")

    # Multichannel, 4 x 150 s.
    chans = ctx["mc_chans"]
    spipe = ShardedPipeline(model, settings=settings, device="cuda")
    spipe.probs_for_waveforms(chans)
    fbank_cuda.launches = 0
    with EPILOGUES.count("multichannel_bf16"):
        rows = spipe.probs_for_waveforms(chans)
    launches["multichannel_bf16"] = fbank_cuda.launches
    check(launches["multichannel_bf16"] == n_buckets,
          f"bf16 multichannel: {launches['multichannel_bf16']} launches")
    d_mc = max(float(np.abs(a - b).max()) for a, b in zip(rows, ctx["mc_rows"]))
    check(d_mc <= 0.05, f"bf16 multichannel rows {d_mc:.3e} from float32 > 0.05")
    m = min(len(w) for w in chans) // 4  # a live meeting's first ~37 s
    equal = [w[:m] for w in chans]
    sess = ShardedStreamingSession(spipe, n_channels=4)
    outs = [sess.feed([w[lo : lo + 4000] for w in equal]) for lo in range(0, m, 4000)]
    full = np.concatenate(outs + [sess.finish()], axis=1)
    check(all(np.array_equal(a, b) for a, b in zip(full, spipe.probs_for_waveforms(equal))),
          "bf16 ShardedStreamingSession differs from the offline batch")
    run = lambda: spipe.probs_for_waveforms(chans)
    best, took = best_wall(run)
    audio_s = sum(len(w) for w in chans) / 16000
    peak = peak_of(run)
    print(f"multichannel 4 x {SECONDS} s, bf16: {launches['multichannel_bf16']} launches; rows vs "
          f"float32 {d_mc:.3e} (limit 0.05); ShardedStreamingSession bit-equal to offline; "
          f"{audio_s / best:.1f} audio-s per wall-s (best of 3) vs float32 {ctx['mc_rate']:.1f} = "
          f"{audio_s / best / ctx['mc_rate']:.3f}x; peak {peak / 2**30:.3f} GiB vs "
          f"{ctx['mc_peak'] / 2**30:.3f} GiB")
    device_breakdown("probs_for_waveforms (4 channels, bf16)", run, best,
                     work / "bf16_multichannel.trace.json")

    # One bf16 sweep of phase 8's corpus (the default precision).
    tdir, adir, paths = ctx["corpus"]
    text = io.StringIO()
    fbank_cuda.launches = 0
    with contextlib.redirect_stdout(text), EPILOGUES.count("sweep_bf16"):
        rc = sweep.main(["--audio_dir", str(adir), "--transcript_dir", str(tdir), "--output_dir",
                         str(work / "sweep_bf16"), "--split", "all", "--model_path", ctx["ckpt"],
                         "--device", "cuda"])
    launches["sweep_bf16"] = fbank_cuda.launches
    check(rc == 0, f"bf16 sweep returned {rc}")
    check(launches["sweep_bf16"] == ctx["sweep_launches"],
          f"bf16 sweep: {launches['sweep_bf16']} fbank launches, the float32 sweep's buckets "
          f"and warm-ups are {ctx['sweep_launches']}")
    got = re.search(r"([\d.]+) audio-s per wall-s end to end, ([\d.]+) inference only",
                    text.getvalue())
    check(got is not None, "bf16 sweep: no summary line")
    thresholds = parse_float_list(sweep.DEFAULT_THRESHOLDS)
    min_lengths = parse_float_list(sweep.DEFAULT_MIN_LENGTHS)
    n_grids = 0
    for meeting, ps in paths.items():
        mprobs, durations = spipe.probs_for_meeting(ps)
        for c, (p, dur) in enumerate(zip(mprobs, durations)):
            inst = smoothing.instances_from_device_probs(torch.from_numpy(p).cuda(), thresholds,
                                                         min_lengths, fps=len(p) / dur)
            for (t, ml), want_i in inst.items():
                g = work / "sweep_bf16" / "all" / meeting / f"t_{t}" / f"l_{ml}" / f"chan{c}.TextGrid"
                check(textgrid.read_laughter_intervals(str(g)) == want_i,
                      f"{g}: the bf16 sweep differs from the bf16 ShardedPipeline's smoothing")
                n_grids += 1
    print(f"bf16 sweep of phase 8's corpus (default precision): {n_grids} TextGrids equal the "
          f"smoothing of the in-process bf16 ShardedPipeline; {launches['sweep_bf16']} launches "
          f"(as the float32 sweep's), the conv epilogue {EPILOGUES.by_path['sweep_bf16']} "
          f"(the float32 sweep: {EPILOGUES.by_path['sweep']}); "
          f"{float(got[1]):.2f} audio-s per wall-s end to end, {float(got[2]):.2f} inference only "
          f"on {card} (float32: phase 8)")
    return launches


def phase_bf16_train(card, work: Path, ctx: dict) -> None:
    """bf16 training with float32 masters at full width on the card, held
    against the port's bf16 step on the CPU at the JAX package's
    mixed-precision tolerances; then one epoch of cli/train --precision
    bfloat16 on phase 10's tables."""
    import contextlib
    import io

    import torch

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.cli import segment_laughter as seg_cli
    from laughter_detection_icsi_tpu_torch.cli import train as train_cli
    from laughter_detection_icsi_tpu_torch.config import FEAT, MODEL_MAP
    from laughter_detection_icsi_tpu_torch.eval import textgrid
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing
    from laughter_detection_icsi_tpu_torch.train import Trainer, step_generator
    from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib

    preset = MODEL_MAP["resnet_base"]
    weights = {k: v.detach().cpu() for k, v in ctx["model"].state_dict().items()}

    def trainer(dropout: float, device, compute_dtype="bfloat16") -> Trainer:
        m = zoo.build(preset.model, dropout_rate=dropout, linear_layer_size=preset.linear_layer_size,
                      filter_sizes=preset.filter_sizes)
        m.load_state_dict(weights, strict=True)
        return Trainer(m, device=device, compute_dtype=compute_dtype)

    with torch.no_grad(), inference.strict_fp32():
        feats = fbank_cuda.fbank_cuda(torch.from_numpy(ctx["pcm"]).to(DEVICE).float() / 32768.0, FEAT)
    rng = np.random.default_rng(19)
    window = torch.arange(100, device=DEVICE)

    def batch(b: int) -> dict:
        starts = torch.from_numpy(rng.integers(0, feats.shape[0] - 100, b)).to(DEVICE)
        return {"inputs": feats[starts[:, None] + window],
                "is_laugh": (rng.uniform(size=b) > 0.5).astype(np.float32)}

    # (a) One step at dropout 0: the card against the port's bf16 step on the CPU.
    b0 = batch(preset.batch_size)
    card_t, cpu_t = trainer(0.0, DEVICE), trainer(0.0, "cpu")
    opt_c, m_c = card_t.train_batch(card_t.init(), b0)
    opt_h, m_h = cpu_t.train_batch(cpu_t.init(), {"inputs": b0["inputs"].cpu(),
                                                  "is_laugh": b0["is_laugh"]})
    loss_c, loss_h = float(m_c["loss"]), float(m_h["loss"])
    check(abs(loss_c - loss_h) <= 2e-2 * abs(loss_h), f"bf16 step: loss card {loss_c} vs CPU {loss_h}")
    want = cpu_t.model.state_dict()
    worst, worst_k = 0.0, None
    for k, v in card_t.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            check(v.dtype == torch.int64, f"{k} is {v.dtype}")
            continue
        check(v.dtype == torch.float32, f"bf16 training: {k} is {v.dtype}, not float32")
        a, b = v.cpu(), want[k]
        excess = ((a - b).abs() - (5e-3 + 5e-2 * b.abs())).max().item()
        if excess > worst or worst_k is None:
            worst, worst_k = excess, k
    check(worst <= 0, f"bf16 step: {worst_k} outside rtol 5e-2 / atol 5e-3 of the CPU's by {worst:.3e}")
    check(all(t.dtype == torch.float32 for tree in (opt_c.mu, opt_c.nu) for t in tree.values()),
          "bf16 training: an Adam moment is not float32")
    print(f"(a) bf16 step, dropout 0, B={preset.batch_size}: loss card {loss_c:.6f} vs CPU bf16 "
          f"{loss_h:.6f} (rtol 2e-2); parameters and BN buffers within rtol 5e-2 / atol 5e-3 of the "
          f"CPU's (closest margin {-worst:.3e}, at {worst_k}); masters, Adam moments and BN "
          f"buffers float32")

    # The backward by itself: one Adam step at lr 1e-3 moves an element by at
    # most ~1e-3, so the parameters above say little of the gradients.  The
    # card's bf16 gradients against the CPU's on three batches; the CPU's
    # float32 gradients and the card's scaled by 0.9 are read beside them,
    # as faults the limits must catch.
    def grads(bt, device, compute_dtype="bfloat16"):
        t = trainer(0.0, device, compute_dtype)
        x, y = t._prep({"inputs": bt["inputs"].to(device), "is_laugh": bt["is_laugh"]})
        return {k: g.float().cpu() for k, g in t.loss_and_grads(x, y)[2].items()}

    for i, bt in enumerate((b0, batch(preset.batch_size), batch(preset.batch_size))):
        g_card, g_cpu, g_f32 = grads(bt, DEVICE), grads(bt, "cpu"), grads(bt, "cpu", None)
        scale = max(1.0, max(g.abs().max().item() for g in g_cpu.values()))
        weights_k = [k for k, g in g_cpu.items() if g.ndim >= 2]

        def grad_err(g):
            return max((g[k] - g_cpu[k]).abs().max().item() for k in g_cpu) / scale

        def min_cos(g):
            cos = {k: float(torch.nn.functional.cosine_similarity(
                g[k].double().flatten(), g_cpu[k].double().flatten(), dim=0)) for k in weights_k}
            k = min(cos, key=cos.get)
            return cos[k], k

        err, (cos, cos_k) = grad_err(g_card), min_cos(g_card)
        err_f32, (cos_f32, _) = grad_err(g_f32), min_cos(g_f32)
        err_scaled = grad_err({k: 0.9 * g for k, g in g_card.items()})
        check(err <= BF16_GRAD_TOL, f"bf16 gradients, batch {i}: card vs CPU {err:.3e} of "
              f"max(1, max|g|) > {BF16_GRAD_TOL} (CPU float32 reads {err_f32:.3e})")
        check(cos >= BF16_GRAD_COS and cos > cos_f32,
              f"bf16 gradients, batch {i}: {cos_k} at cosine {cos:.4f} with the CPU's, "
              f"below {BF16_GRAD_COS} or the CPU float32 gradients' {cos_f32:.4f}")
        print(f"(a) bf16 gradients, batch {i}, card vs CPU bf16: {err:.4e} of max(1, max|g|) = "
              f"{scale:.4g} (limit {BF16_GRAD_TOL}; CPU float32 reads {err_f32:.4e}, the card's "
              f"x 0.9 {err_scaled:.4e}); least cosine of a weight's gradient {cos:.4f} at {cos_k} "
              f"over {len(weights_k)} weights (limit {BF16_GRAD_COS} and above CPU float32's "
              f"{cos_f32:.4f})")

    # (b) 20 steps at dropout 0.5 on one batch.
    t = trainer(0.5, DEVICE)
    opt, losses = t.init(), []
    with EPILOGUES.count("train_steps_bf16"):
        for step in range(20):
            opt, m = t.train_batch(opt, b0, step_generator(0, step, DEVICE))
            losses.append(m["loss"])
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"bf16, 20 steps on one batch: losses {losses[0]:.4f} ... {losses[-1]:.4f}")
    print(f"(b) bf16, 20 steps, dropout 0.5, one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    # (c) Steps per second beside phase 9's float32.
    for b in TRAIN_SIZES:
        t = trainer(0.5, DEVICE)
        opt = t.init()
        bb = batch(b)
        n_steps = 50 if b <= 64 else 20
        gens = [step_generator(1, s, DEVICE) for s in range(n_steps)]
        for s in range(3):
            opt, _ = t.train_batch(opt, bb, gens[s])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for s in range(n_steps):
                opt, _ = t.train_batch(opt, bb, gens[s])
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / n_steps)
        peak = torch.cuda.max_memory_allocated()
        f32 = ctx["train_rate"][b]
        print(f"(c) bf16 B={b} on {card}: {1e3 / min(ms):.2f} train steps per second (best of 3 x "
              f"{n_steps}: {', '.join(f'{d:.3f}' for d in ms)} ms a step) vs float32 {f32:.2f} "
              f"(phase 9) = {1e3 / min(ms) / f32:.3f}x; peak device memory {peak / 2**30:.3f} GiB")
        train_breakdown(f"bf16 B={b}", lambda: t.train_batch(opt, bb, gens[0]),
                        work / f"train_bf16_{b}.trace.json")

    # (d) cli/train --precision bfloat16, one epoch, resident; its checkpoint
    # loads in float32 and segments through the CLI.
    root, dfs, feats_dir, adir = ctx["train_data_cli"]
    out_dir = root / "bf16"
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = train_cli.main(["--config", "resnet_base", "--data_root", str(root), "--data_dfs_dir",
                             str(dfs), "--feats_dir", str(feats_dir), "--signals_dir", str(adir),
                             "--device", DEVICE, "--seed", "3", "--checkpoint_dir", str(out_dir),
                             "--precision", "bfloat16", "--device_cache", "on"])
    epoch_s = time.perf_counter() - t0
    check(rc == 0, f"cli/train --precision bfloat16 returned {rc}: {text.getvalue()[-600:]}")
    loaded = ckpt_lib.load_checkpoint(str(out_dir / "last.ckpt.npz"))
    check(loaded["epoch"] == 1 and all(
        v.dtype == (torch.int64 if k.endswith("num_batches_tracked") else torch.float32)
        for k, v in loaded["state_dict"].items()), "the bf16 run's checkpoint is not float32")
    trained = zoo.build(preset.model, dropout_rate=0.0, linear_layer_size=preset.linear_layer_size,
                        filter_sizes=preset.filter_sizes)
    best = ckpt_lib.resolve_checkpoint(str(out_dir))  # what the CLI's --model_path reads
    trained.load_state_dict(ckpt_lib.load_checkpoint(best)["state_dict"], strict=True)
    pipe = inference.LaughterPipeline(trained, settings=inference.settings_from_flags(device=DEVICE),
                                      device=DEVICE)
    probs, _ = pipe.probs_for_file(str(ctx["wav"]))
    check_probs(probs, ctx["probs"].shape, "bf16-trained checkpoint")
    thr = midway_threshold(probs)
    out = work / "out_bf16_trained"
    rc = seg_cli.main(["--model_path", str(out_dir), "--input_audio_file", str(ctx["wav"]),
                       "--output_dir", str(out), "--thresholds", f"{thr}", "--min_lengths", "0.2",
                       "--save_to_textgrid", "True", "--save_to_audio_files", "False",
                       "--device", DEVICE])
    check(rc == 0, f"segment CLI on the bf16-trained checkpoint returned {rc}")
    got = textgrid.read_laughter_intervals(str(out / f"t_{thr}" / "l_0.2" / "meeting.TextGrid"))
    check(got == smoothing.get_laughter_instances(probs, [thr], [0.2])[(thr, 0.2)],
          "the bf16-trained checkpoint's TextGrid differs from LaughterPipeline's")
    steps = loaded["global_step"]
    print(f"(d) cli/train --precision bfloat16 --device_cache on: one epoch of {steps} steps in "
          f"{epoch_s:.1f} s on {card} (float32 resident: phase 10 (c)); the checkpoint is float32; "
          f"{Path(best).name} loads and segments through cli/segment_laughter (bf16 default): "
          f"{len(got)} instances at threshold {thr}, equal to LaughterPipeline's smoothing")


#: Run in a fresh interpreter by the export phase: the serving host's side
#: of an e2e artifact, which imports only the port's export and host_prep.
E2E_HOST = r"""
import json, sys, time
import numpy as np
import torch
from laughter_detection_icsi_tpu_torch import export, host_prep
art_path, wav_npy, out_npy, bucket = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
art = export.load(art_path)
pcm = np.load(wav_npy)
geo = host_prep.BucketGeometry(bucket_frames=bucket)
buckets = list(host_prep.bucket_inputs(pcm, settings=geo))
from laughter_detection_icsi_tpu_torch.ops import bn_act_cuda  # export imported it
export.fbank_cuda.launches = bn_act_cuda.launches = bn_act_cuda.launches_padded = 0
probs = torch.cat([art.call(buf, valid)[:n] for buf, valid, n in buckets]).cpu().numpy()
launches, epilogues = export.fbank_cuda.launches, bn_act_cuda.launches
padded = bn_act_cuda.launches_padded
np.save(out_npy, probs)
bufs = [(torch.from_numpy(b).cuda(), torch.tensor(v, device="cuda")) for b, v, _ in buckets]
for b, v in bufs:
    art.call(b, v)
per = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b, v in bufs:
        art.call(b, v)
    torch.cuda.synchronize()
    per.append(1e3 * (time.perf_counter() - t0) / len(bufs))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pandas", "lxml"))
print(json.dumps({"launches": launches, "epilogues": epilogues, "padded": padded,
                  "buckets": len(buckets),
                  "ms_per_bucket": per,
                  "precision": art.precision, "device": str(art.device), "forbidden": loaded}))
"""


def phase_export(card, work: Path, ctx: dict) -> int:
    """cli/export_model's window and e2e artifacts on the card, each loaded
    back and held against the live model or pipeline (the e2e artifact in a
    fresh process that imports only export and host_prep), and
    cli/convert_checkpoint's round trip; returns the kernel launches inside
    the e2e artifact."""
    import contextlib
    import io

    import torch

    from laughter_detection_icsi_tpu_torch import export, host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli import convert_checkpoint, export_model
    from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib

    model, ckpt = ctx["model"], ctx["ckpt"]

    def cli(argv):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = export_model.main(argv)
        check(rc == 0, f"export_model {' '.join(argv)} returned {rc}")
        return text.getvalue()

    rng = np.random.default_rng(23)
    bf16_model = inference.cast_model_bf16(model).eval()
    for prec, tol in (("float32", 1e-6), ("bfloat16", 2e-2)):
        path = work / f"windows_{prec}.pt2"
        said = cli(["--model_path", ckpt, "--what", "windows", "--precision", prec,
                    "--out", str(path), "--device", "cuda"])
        art = export.load(str(path))
        live = model if prec == "float32" else bf16_model
        errs = []
        for b in (1, 37, 6144):
            x = torch.from_numpy((rng.standard_normal((b, 1, 100, 44)) * 3).astype(np.float32)).cuda()
            got = art.call(x)
            with torch.inference_mode(), inference.precision_scope(prec):
                want = live(x.to(next(live.parameters()).dtype)).float()
            check(got.shape == (b,) and got.dtype == torch.float32, f"windows artifact: {got.shape}")
            errs.append((got - want).abs().max().item())
            check(errs[-1] <= tol, f"{prec} windows artifact at B={b}: {errs[-1]:.3e} > {tol}")
        print(f"windows artifact, {prec}, symbolic batch ({path.stat().st_size:,} bytes; "
              f"{said.splitlines()[-1]}): at B = 1, 37, 6144 max |artifact - live| = "
              f"{', '.join(f'{e:.3e}' for e in errs)} (limit {tol})")

    # The e2e artifact at chunk and bucket 6144, run by a fresh process.
    path = work / "e2e.pt2"
    said = cli(["--model_path", ckpt, "--what", "e2e", "--wave_dtype", "int16", "--chunk", "6144",
                "--bucket_frames", "6144", "--out", str(path), "--device", "cuda"])
    np.save(work / "pcm.npy", ctx["pcm"])
    proc = subprocess.run([sys.executable, "-c", E2E_HOST, str(path), str(work / "pcm.npy"),
                           str(work / "e2e_probs.npy"), "6144"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the e2e host process exited {proc.returncode}: {proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not res["forbidden"], f"the e2e host loaded {res['forbidden']}")
    n_buckets = -(-host_prep.num_frames(len(ctx["pcm"])) // 6144)
    check(res["launches"] == res["buckets"] == n_buckets,
          f"e2e artifact: {res['launches']} launches for {res['buckets']} buckets")
    got = np.load(work / "e2e_probs.npy")
    pipe = inference.LaughterPipeline(model, device="cuda", settings=inference.InferenceSettings(
        chunk=6144, bucket_frames=6144))  # the artifact's settings, float32
    EPILOGUES.check("e2e_artifact", res["epilogues"],
                    n_buckets * convs_per_bucket(model, pipe.settings, pipe.shared_stem),
                    padded=(res["padded"], n_buckets * padded_per_bucket(
                        model, pipe.settings, pipe.shared_stem)))
    want = pipe.probs_for_waveform(ctx["pcm"])
    d_e2e = float(np.abs(got - want).max()) if got.shape == want.shape else math.inf
    check(d_e2e <= 1e-6, f"e2e artifact vs LaughterPipeline: {d_e2e:.3e} > 1e-6")
    padded, t = host_prep.host_pad_waveform(ctx["pcm"])
    bufs = list(pipe.bucket_buffers(padded, t))
    live_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for buf, valid, _ in bufs:
            pipe._bucket_probs(buf, valid)
        torch.cuda.synchronize()
        live_ms.append(1e3 * (time.perf_counter() - t0) / len(bufs))
    print(f"e2e artifact ({path.stat().st_size:,} bytes; {said.splitlines()[-1]}) in a fresh "
          f"process that imports only export and host_prep (no jax, pandas or lxml loaded): "
          f"{res['launches']} fbank launches for {res['buckets']} buckets, "
          f"{res['epilogues']} of the conv epilogue; "
          + ("bit-equal to" if d_e2e == 0 else f"max |diff| {d_e2e:.3e} (limit 1e-6) from")
          + f" LaughterPipeline.probs_for_waveform; {min(res['ms_per_bucket']):.3f} ms a bucket "
          f"(host clock, best of 3, the buffers on the card) vs the live pipeline's "
          f"{min(live_ms):.3f} ms (the same, from host buffers) on {card}")

    # cli/convert_checkpoint: .ckpt.npz -> .pth.tar -> .ckpt.npz.
    pth, back = str(work / "conv.pth.tar"), str(work / "conv_back.ckpt.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        check(convert_checkpoint.main([ckpt, pth]) == 0 and convert_checkpoint.main([pth, back]) == 0,
              "convert_checkpoint failed")
    a, b = ckpt_lib.load_checkpoint(ckpt)["state_dict"], ckpt_lib.load_checkpoint(back)["state_dict"]
    check(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a),
          "the converted checkpoint's tensors differ")
    print(f"cli/convert_checkpoint .ckpt.npz -> .pth.tar -> .ckpt.npz: {len(a)} tensors equal")
    return res["launches"]


#: Phase 14: the global batch of the data-parallel steps, the steps held
#: one by one against one process, the steps of the SIGTERM epoch, and the
#: seconds after which a spawned process group is killed.
MP_BATCH = 64
MP_STEPS = 3
MP_EPOCH = 8
RANK_TIMEOUT = 300
MP_EPOCH_SEED, MP_SEED = 5, 11  # the batch order's seed; the dropout's


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` calls between two CUDA events
    (the host's gaps included: a step that waits on the host, as a Gloo
    collective does, cannot be queued ahead of the device)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def spawn_ranks(argv_of, n: int = 2, timeout: float = RANK_TIMEOUT):
    """``n`` processes, the command of rank r ``argv_of(r)``, run from the
    checkout's root; [(rc, stdout, stderr)] by rank.  All are killed when
    one outlives ``timeout`` (which then fails the phase)."""
    procs = [subprocess.Popen(argv_of(r), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            logs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        raise PhaseError(f"a process of the group outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def worker_argv(task: str, spec: Path):
    return lambda r: [sys.executable, str(REPO / "chip_smoke.py"), "--worker", task, str(spec), str(r)]


def check_ranks(logs, what: str) -> None:
    for r, (rc, out, err) in enumerate(logs):
        check(rc == 0, f"{what}: rank {r} exited {rc}:\n{out[-1500:]}\n{err[-3000:]}")


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def grad_err(got: dict, truth: dict) -> float:
    """The largest distance of a gradient from float64 truth, as a share
    of max(1, the leaf's max |truth|) (phase 9's scale: full-width
    gradients reach ~1e2)."""
    return max((got[k].double() - t).abs().max().item() / max(1.0, t.abs().max().item())
               for k, t in truth.items())


def grads_f64(model, x, y, generator) -> dict:
    """Float64 truth of a train-mode step's gradients: ``model`` (its
    state as the step starts, dropout drawn from ``generator``) in
    float64 on the batch's float32 values."""
    import torch
    import torch.nn.functional as F

    m = model.double().train()
    names, params = zip(*m.named_parameters())
    loss = F.binary_cross_entropy(m(x.double(), generator=generator), y.double())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def check_grads(two: dict, one: dict, truth: dict, what: str) -> tuple:
    """The two-process gradients are within 1e-4 of float64 truth, or no
    further from it than 1.5x the one-process float32 step is (the rule of
    phase 3's tone: at full width on phase 10's features a float32 step's
    gradients are ~1e-3 of max |g| from truth whichever way it sums, and
    two float32 steps are no nearer each other).  Returns both errors."""
    e2, e1 = grad_err(two, truth), grad_err(one, truth)
    check(e2 <= max(1e-4, 1.5 * e1),
          f"{what}: gradients {e2:.3e} from float64 truth, one process's {e1:.3e} "
          f"(as a share of max(1, max |g|); limit max(1e-4, 1.5x one process's))")
    return e2, e1


def same_step(two: dict, one: dict, start: dict, truth: dict, what: str) -> dict:
    """Checkpoint ``two`` (two processes) took the step that ``one`` (one
    process) took from the parameters ``start``, read from the
    checkpoints' Adam state (the first moment over 0.1 is the clipped
    gradient): BatchNorm's running statistics within 1e-6, the gradients by
    :func:`check_grads` against ``truth`` clipped as ``one``'s were, and
    the parameters within 1e-6 of Adam applied to the checkpoint's own
    gradients.  Returns the largest differences."""
    from laughter_detection_icsi_tpu_torch.train import Adam
    from laughter_detection_icsi_tpu_torch.train.optim import global_norm

    sa, sb = two["state_dict"], one["state_dict"]
    check(sa.keys() == sb.keys(), f"{what}: other tensors")
    bn = max((sa[n] - sb[n]).abs().max().item() for n in sa
             if n.endswith(("running_mean", "running_var")))
    adam = Adam(max_grad_norm=None)  # the moment holds the clipped gradient
    g_a = {k: m / (1 - adam.b1) for k, m in two["opt_state"].mu.items()}
    g_b = {k: m / (1 - adam.b1) for k, m in one["opt_state"].mu.items()}
    scale = min(1.0, 1.0 / (float(global_norm(truth)) + 1e-6))
    grad, grad_one = check_grads(g_a, g_b, {k: t * scale for k, t in truth.items()}, what)
    redo = {k: v.clone() for k, v in start.items()}
    adam.update(g_a, adam.init(redo), redo)
    own = max((sa[k] - redo[k]).abs().max().item() for k in g_a)
    check(bn <= 1e-6 and own <= 1e-6,
          f"{what}: BN stats {bn:.3e} (1e-6), parameters {own:.3e} from Adam on their own "
          f"gradients (1e-6)")
    return dict(bn=bn, grad=grad, grad_one=grad_one, own=own)


def phase_multiprocess(card, work: Path, ctx: dict) -> dict:
    """Multi-process (see the module docstring, phase 14); returns each
    rank's fbank launches in the two-process sweep and training."""
    import contextlib
    import datetime
    import io
    import itertools

    import torch
    import torch.distributed as dist

    from laughter_detection_icsi_tpu_torch import host_prep
    from laughter_detection_icsi_tpu_torch.cli import sweep as sweep_cli
    from laughter_detection_icsi_tpu_torch.cli import train as train_cli
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
    from laughter_detection_icsi_tpu_torch.data import FeatureCache, LadDataset, audio, load_split_df
    from laughter_detection_icsi_tpu_torch.eval import analyse as an
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda
    from laughter_detection_icsi_tpu_torch.parallel import DataParallelTrainer, distributed
    from laughter_detection_icsi_tpu_torch.train import AdamState, Trainer
    from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib

    preset = MODEL_MAP["resnet_base"]
    root, dfs, feats, adir = ctx["train_data"]
    tdir = ctx["corpus"][0]
    mp = work / "multiprocess"
    mp.mkdir()
    rows = load_split_df(str(dfs), "train")[: MP_EPOCH * MP_BATCH]
    check(len(rows) == MP_EPOCH * MP_BATCH, f"phase 10's train table has {len(rows)} rows")
    (mp / "rows.json").write_text(json.dumps(rows))
    ds = LadDataset(rows, FeatureCache(str(feats)))
    weights = {k: v.detach().cpu() for k, v in zoo.build(
        preset.model, dropout_rate=0.5, linear_layer_size=preset.linear_layer_size,
        filter_sizes=preset.filter_sizes, seed=3).state_dict().items()}
    torch.save(weights, mp / "weights.pt")

    def model(dropout: float = 0.5):
        m = zoo.build(preset.model, dropout_rate=dropout, linear_layer_size=preset.linear_layer_size,
                      filter_sizes=preset.filter_sizes)
        m.load_state_dict(weights, strict=True)
        return m

    def epoch_batches(n=None):
        return itertools.islice(ds.batches(MP_BATCH, seed=MP_EPOCH_SEED, drop_remainder=True,
                                           prefetch=0), n)

    # (a) One process in an NCCL group of one on the card, cuDNN
    # deterministic: the two trainers run the same kernels on the same
    # values (Adam's first step would turn any rounding difference of a
    # zero-gradient element into an lr-sized move).
    batch = next(epoch_batches(1))
    distributed.initialize(coordinator_address=f"file://{mp / 'store_a'}", num_processes=1,
                           process_id=0, device=DEVICE, timeout=datetime.timedelta(seconds=120))
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic, cudnn.benchmark = True, False
        backend = dist.get_backend()
        check(backend == ("nccl" if DEVICE == "cuda" else "gloo"), f"(a): backend {backend}")
        one, dp = Trainer(model(), device=DEVICE), DataParallelTrainer(model(), device=DEVICE)
        oa, ma = one.train_batch(one.init(), batch, one.generator(MP_SEED, 0))
        ob, mb = dp.train_batch(dp.init(), batch, dp.generator(MP_SEED, 0))
        d_loss = abs(float(ma["loss"]) - float(mb["loss"]))
        d_par = max((a - b).abs().max().item() for a, b in zip(
            one.model.state_dict().values(), dp.model.state_dict().values()))
        check(d_loss <= 1e-6 and d_par <= 1e-6,
              f"(a): DataParallelTrainer vs Trainer: loss {d_loss:.3e}, state {d_par:.3e} (1e-6)")
        rates = {}
        for name, t, o in (("Trainer", one, oa), ("DataParallelTrainer", dp, ob)):
            gen = t.generator(MP_SEED, 1)
            rates[name] = 1e3 / event_ms(lambda: t.train_batch(o, batch, gen))
        flat = torch.cat([p.detach().reshape(-1) for p in dp.model.parameters()])
        ar_ms = cuda_ms(lambda: dist.all_reduce(flat), iters=50)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        dist.destroy_process_group()
    print(f"(a) NCCL group of one on {card}: DataParallelTrainer's step at B = {MP_BATCH} equals "
          f"Trainer's (loss {d_loss:.3e}, weights and buffers {d_par:.3e}; limit 1e-6); "
          f"steps per second (CUDA events, 20 steps): Trainer {rates['Trainer']:.2f}, "
          f"DataParallelTrainer {rates['DataParallelTrainer']:.2f}; one NCCL all_reduce of the "
          f"flattened gradients ({flat.numel():,} float32, {4 * flat.numel():,} bytes) "
          f"{ar_ms:.4f} ms")

    # (b) Two processes sharing the card over Gloo.
    spec = dict(device=DEVICE, store=str(mp / "store_b"), weights=str(mp / "weights.pt"),
                rows=str(mp / "rows.json"), feats=str(feats), out=str(mp), batch=MP_BATCH,
                steps=MP_STEPS, epoch_seed=MP_EPOCH_SEED, seed=MP_SEED)
    (mp / "b.json").write_text(json.dumps(spec))
    logs = spawn_ranks(worker_argv("dp", mp / "b.json"))
    check_ranks(logs, "(b)")
    rep = [last_json(out) for _, out, _ in logs]
    steps = torch.load(mp / "steps.pt")
    errs = dict(loss=0.0, grad=0.0, grad_one=0.0, bn=0.0, own=0.0)
    for k, b in enumerate(epoch_batches(MP_STEPS)):
        pre, post = steps[k]["pre"], steps[k]["post"]
        t = Trainer(model(), device=DEVICE)
        t.model.load_state_dict(pre["sd"], strict=True)
        opt = AdamState(step=pre["step"].to(DEVICE), mu={n: v.to(DEVICE) for n, v in pre["mu"].items()},
                        nu={n: v.to(DEVICE) for n, v in pre["nu"].items()})
        x, y = t._prep(b)
        truth_model = model()
        truth_model.load_state_dict(pre["sd"], strict=True)
        truth = grads_f64(truth_model.to(DEVICE), x, y, t.generator(MP_SEED, k))
        loss, _, grads = t.loss_and_grads(x, y, t.generator(MP_SEED, k))
        two_g = {n: g.to(DEVICE) for n, g in steps[k]["grads"].items()}
        errs["loss"] = max(errs["loss"], abs(float(loss) - steps[k]["loss"]))
        e2, e1 = check_grads(two_g, grads, truth, f"(b) step {k}")
        errs["grad"], errs["grad_one"] = max(errs["grad"], e2), max(errs["grad_one"], e1)
        sd = t.model.state_dict()
        errs["bn"] = max(errs["bn"], max((sd[n] - post[n].to(DEVICE)).abs().max().item()
                                         for n in sd if n.endswith(("running_mean", "running_var"))))
        redo = {n: v.detach().clone() for n, v in t.params.items()}
        t.optimizer.update(two_g, opt, redo)
        errs["own"] = max(errs["own"], max((post[n].to(DEVICE) - p).abs().max().item()
                                           for n, p in redo.items()))
    check(errs["loss"] <= 1e-5 and errs["bn"] <= 1e-6 and errs["own"] <= 1e-6,
          f"(b) two processes vs one, step by step: {errs}")
    print(f"(b) two processes sharing {card} over Gloo, global B = {MP_BATCH} ({MP_BATCH // 2} a "
          f"process), dropout 0.5, {MP_STEPS} steps, each from the two-process state against one "
          f"process's step: loss {errs['loss']:.3e} (1e-5); gradients {errs['grad']:.3e} from "
          f"float64 truth as a share of max(1, the leaf's max |g|), one process's float32 "
          f"{errs['grad_one']:.3e} (limit max(1e-4, 1.5x one process's)); BN running statistics "
          f"{errs['bn']:.3e} (1e-6); parameters {errs['own']:.3e} from one process's Adam on the "
          f"two-process gradients from the same state (1e-6)")
    r0 = rep[0]
    check(r0["resident_vs_streamed"] <= 1e-6,
          f"(b) the resident gather step vs the streamed step: {r0['resident_vs_streamed']:.3e}")
    print(f"    the sharded resident split's gather step vs the streamed local-rows step: max "
          f"|diff| {r0['resident_vs_streamed']:.3e} (limit 1e-6); each process holds "
          f"{r0['resident_rows']} of {len(rows)} rows")
    print(f"    on {card}: two-process step {r0['step_ms']:.3f} ms at global B = {MP_BATCH} "
          f"(host clock, 20 steps; rank 1 {rep[1]['step_ms']:.3f} ms), {1e3 / r0['step_ms']:.2f} "
          f"steps per second (one process, (a): {1e3 / rates['DataParallelTrainer']:.3f} ms); a "
          f"step runs {r0['collectives']} Gloo all_reduces of {r0['collective_floats']:,} floats "
          f"(BatchNorm's sums forward and backward, then one of the gradients and the metric "
          f"counts), a 64-float one {r0['small_ms']:.3f} ms; one of the flattened gradients "
          f"({r0['grad_bytes']:,} bytes, CUDA tensors staged through the host) "
          f"{r0['allreduce_ms']:.3f} ms; the resident gather's all_reduce "
          f"({r0['gather_bytes']:,} bytes) {r0['gather_ms']:.3f} ms; a preemption vote over the "
          f"CPU group {r0['vote_ms']:.3f} ms")
    check(all(r["stopped"] == [4, True] for r in rep),
          f"(b) SIGTERM to rank 1: stops {[r['stopped'] for r in rep]}, want both at step 4")
    logs = spawn_ranks(worker_argv("resume", mp / "b.json"))
    check_ranks(logs, "(b) resume")
    whole = ckpt_lib.load_checkpoint(str(mp / "whole" / "last.ckpt.npz"))
    resumed = ckpt_lib.load_checkpoint(str(mp / "cut0" / "last.ckpt.npz"))
    check(not (mp / "cut1" / "last.ckpt.npz").exists(), "(b): rank 1 wrote a checkpoint")
    pairs = [(v, whole["state_dict"][k]) for k, v in resumed["state_dict"].items()]
    pairs += [(getattr(resumed["opt_state"], m)[k], getattr(whole["opt_state"], m)[k])
              for m in ("mu", "nu") for k in whole["opt_state"].mu]
    d_resume = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    check(d_resume <= 1e-6 and (resumed["global_step"], resumed["epoch"]) == (MP_EPOCH, 1),
          f"(b) interrupted + resumed vs uninterrupted: {d_resume:.3e}, counters "
          f"{resumed['global_step']}, {resumed['epoch']}")
    print(f"    SIGTERM to rank 1 before step 4: both stopped at the vote after step 4, rank 0 "
          f"saved; resumed with rank 1's checkpoint dir empty (sync_resume from rank 0): the "
          f"epoch's end state is {d_resume:.3e} from the uninterrupted run's (limit 1e-6)")
    if DEVICE == "cuda":
        (mp / "nccl.json").write_text(json.dumps(dict(spec, store=str(mp / "store_nccl"))))
        logs = spawn_ranks(worker_argv("nccl", mp / "nccl.json"))
        check_ranks(logs, "NCCL on one card")
        print(f"    two processes on one card over NCCL refuse, each: {last_json(logs[0][1])['refused']}")

    # (c) cli/sweep over phase 8's Bmr021 on two processes.
    meeting = "Bmr021"
    n_ch = len(ctx["corpus"][2][meeting])
    sweep_argv = lambda out: ["--audio_dir", str(ctx["corpus"][1]), "--transcript_dir", str(tdir),
                              "--output_dir", str(out), "--split", "all", "--meetings", meeting,
                              "--analyse", "--model_path", ctx["ckpt"], "--device", DEVICE,
                              "--precision", "float32"]
    text = io.StringIO()
    fbank_cuda.launches = 0
    with contextlib.redirect_stdout(text):
        rc = sweep_cli.main(sweep_argv(mp / "sweep_one"))
    check(rc == 0, f"(c) one-process sweep returned {rc}")
    one_launches, one_out = fbank_cuda.launches, text.getvalue()

    def cli_spec(name: str, argv) -> Path:
        path = mp / f"{name}.json"
        path.write_text(json.dumps(dict(spec, argv=argv, module=name,
                                        store=str(mp / f"store_{name}"))))
        return path

    logs = spawn_ranks(worker_argv("cli", cli_spec("sweep", sweep_argv(mp / "sweep_two"))))
    check_ranks(logs, "(c) two-process sweep")
    sweep_launches = [last_json(out)["launches"] for _, out, _ in logs]
    n_batches = -(-max(host_prep.num_frames(audio.info(p).num_samples)
                       for p in ctx["corpus"][2][meeting]) // ctx["pipe"].settings.bucket_frames)
    want = 1 + n_batches
    check(one_launches == want and sweep_launches == [want, want],
          f"(c) fbank launches: one process {one_launches}, the two {sweep_launches}, want {want} "
          f"each ({n_batches} bucket batches + 1 warm-up)")
    a, b = mp / "sweep_one" / "all", mp / "sweep_two" / "all"
    grids = sorted(p.relative_to(a) for p in a.rglob("*.TextGrid"))
    check(grids == sorted(p.relative_to(b) for p in b.rglob("*.TextGrid")) and len(grids) == 87 * n_ch
          and all((a / p).read_bytes() == (b / p).read_bytes() for p in grids),
          "(c) the two-process sweep's TextGrids differ from one process's")
    stats = [an.read_csv(str(d.parent / "all_sum_stats.csv"), an.SumStats) for d in (a, b)]
    check(rows_equal(stats[0], stats[1]), "(c) the analyse rows differ")
    rate = lambda out: float(re.search(r"([\d.]+) audio-s per wall-s end to end", out)[1])
    secs = audio.info(ctx["corpus"][2][meeting][0]).duration
    print(f"(c) cli/sweep of {meeting} ({n_ch} x {secs:.0f} s) on two processes sharing {card} "
          f"(--cpu_collectives gloo): {len(grids)} TextGrids equal to one process's byte for "
          f"byte, {len(stats[0])} analyse rows equal (rank 0 alone analyses); fbank launched "
          f"{sweep_launches[0]} times on rank 0 and {sweep_launches[1]} on rank 1 ({n_batches} "
          f"bucket batches of its 2 channels + 1 warm-up), one process {one_launches} for 4 "
          f"channels; end to end {rate(logs[0][1]):.2f} audio-s per wall-s (rank 0's loop) "
          f"against one process's {rate(one_out):.2f}")

    # (d) cli/train --data_parallel on two processes: a one-batch epoch of
    # phase 10's tables, the two-process run featurizing into a fresh cache.
    cut = root / "data_dfs_mp"
    cut.mkdir()
    for split in ("train", "dev"):
        lines = (dfs / f"{split}_df.csv").read_text().splitlines(keepends=True)
        (cut / f"{split}_df.csv").write_text("".join(lines[: 1 + MP_BATCH]))
    train_argv = lambda name, feats_dir: [
        "--config", "resnet_base", "--checkpoint_dir", str(mp / name), "--data_root", str(root),
        "--data_dfs_dir", str(cut), "--feats_dir", str(feats_dir), "--signals_dir", str(adir),
        "--device", DEVICE, "--batch_size", str(MP_BATCH), "--device_cache", "on",
        "--data_parallel", "--seed", "3"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = train_cli.main(train_argv("train_one", feats))
    check(rc == 0 and "data-parallel over 1 devices" in text.getvalue(),
          f"(d) one-process train: {text.getvalue()[-500:]}")
    logs = spawn_ranks(worker_argv("cli", cli_spec("train", train_argv("train_two", mp / "feats_two"))))
    check_ranks(logs, "(d) two-process train")
    train_launches = [last_json(out)["launches"] for _, out, _ in logs]
    n_tracks = len({(r["meeting_id"], r["chan_id"]) for split in ("train", "dev")
                    for r in load_split_df(str(cut), split)})
    check(train_launches[0] >= n_tracks and train_launches[1] == 0,
          f"(d) featurization launches by rank {train_launches} for {n_tracks} tracks")
    check(f"device cache: {MP_BATCH} train windows resident" in logs[0][1]
          and f"feeds {MP_BATCH // 2} of {MP_BATCH} rows/batch" in logs[1][1],
          f"(d): {logs[0][1][-600:]}")
    # Float64 truth of the CLI's one step: its batch (epoch seed --seed +
    # epoch) and dropout (seed --seed * 1000 + epoch, global step 0).
    t = Trainer(model(), device=DEVICE)
    cut_ds = LadDataset(load_split_df(str(cut), "train"), FeatureCache(str(feats)))
    x, y = t._prep(next(cut_ds.batches(MP_BATCH, seed=3, drop_remainder=True, prefetch=0)))
    truth = {k: v.cpu() for k, v in grads_f64(model().to(DEVICE), x, y,
                                               t.generator(3000, 0)).items()}
    params = dict(model().named_parameters())
    got = same_step(ckpt_lib.load_checkpoint(str(mp / "train_two" / "last.ckpt.npz")),
                    ckpt_lib.load_checkpoint(str(mp / "train_one" / "last.ckpt.npz")),
                    {k: v for k, v in weights.items() if k in params}, truth, "(d)")
    print(f"(d) cli/train --data_parallel --device_cache on on two processes, a one-batch epoch "
          f"({MP_BATCH} rows of phase 10's train table; {n_tracks} tracks featurized by rank 0 "
          f"into a fresh cache, {train_launches[0]} fbank launches, rank 1 {train_launches[1]} "
          f"after the barrier): its last.ckpt.npz took one process's step (read from the "
          f"checkpoints' Adam moments): gradients {got['grad']:.3e} from float64 truth, one "
          f"process's {got['grad_one']:.3e} (limit max(1e-4, 1.5x one process's)), BN statistics "
          f"{got['bn']:.3e} (1e-6), parameters {got['own']:.3e} from Adam on their own gradients "
          f"(1e-6)")
    return dict(sweep=sweep_launches, train=train_launches)


PARITY_GOLDENS = REPO / "tests" / "fixtures" / "parity_goldens"
PARITY_PROB_ATOL = 1e-4  # the card against the port on the CPU (phase 4's limit)


def phase_parity(card, work: Path, ctx: dict) -> dict:
    """The port against the JAX package's committed goldens, the demos and
    the host tools (see the module docstring, phase 16).  Returns the fbank
    launches of each new path."""
    import contextlib
    import io

    import torch

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.cli import laughs_to_wav, parity, probe_audio_loading
    from laughter_detection_icsi_tpu_torch.data import audio
    from laughter_detection_icsi_tpu_torch.eval import textgrid
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

    # The drill's inputs, imported as the examples import the fixtures: with
    # tests/ first on the path, no installed ``tests`` package can shadow them.
    sys.path.insert(0, str(REPO / "tests"))
    from fixtures import parity_inputs

    t0 = time.perf_counter()
    # (b) The demos run as processes of their own while (a) runs here.
    demo_dir = work / "demo_torch"
    demos = {name: subprocess.Popen([sys.executable, script, *extra, "--device", "cuda"],
                                    cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, script, extra in (("demo", "examples/demo_torch.py", [str(demo_dir)]),
                                         ("streaming", "examples/streaming_demo_torch.py", []))}
    try:
        # (a) The parity CLI on the card against the goldens the JAX CLI wrote.
        inputs = parity_inputs.write_parity_inputs(work / "parity")
        report_path = work / "parity_report.json"
        feature_launches = []
        check_features = parity._check_features

        def counted(*a, **k):
            before = fbank_cuda.launches
            try:
                return check_features(*a, **k)
            finally:
                feature_launches.append(fbank_cuda.launches - before)

        parity._check_features = counted
        fbank_cuda.launches = 0
        try:
            with contextlib.redirect_stdout(io.StringIO()) as text, EPILOGUES.count("parity_run"):
                rc = parity.main(inputs.argv(PARITY_GOLDENS) + [
                    "--device", "cuda", "--prob_atol", str(PARITY_PROB_ATOL),
                    "--out", str(report_path)])
            torch.cuda.synchronize()
        finally:
            parity._check_features = check_features
        run_launches = fbank_cuda.launches
        report = json.loads(report_path.read_text())
        check(rc == 0 and report["n_pass"] == 5 and report["n_skipped"] == 0,
              f"parity CLI: rc {rc}, {report['n_pass']} pass, {report['n_skipped']} skipped: "
              f"{text.getvalue()[-3000:]}")
        n_files = len(parity_inputs.CHANNELS)
        buckets = -(-int(parity_inputs.SECONDS * 100) // 1024)  # the goldens' bucket
        # features one launch a file; probs and textgrids one a bucket a file;
        # the sweep one a bucket batch of the meeting plus its warm-up.
        want = n_files + 2 * n_files * buckets + buckets + 1
        check(feature_launches == [n_files] and run_launches == want,
              f"parity CLI: fbank launches {feature_launches} in the features check (want "
              f"{n_files}), {run_launches} in the run (want {want})")
        rows = [("features", "max_abs_diff", "atol"), ("probs", "max_abs_diff", "atol"),
                ("textgrids", "max_boundary_diff_s", "tol_s"),
                ("analyse", "max_metric_diff", "atol"), ("loss_curve", "max_loss_diff", "atol")]
        for name, diff, tol in rows:
            r = report["configs"][name]
            print(f"  parity {name}: {r['status']}, {diff} {r[diff]:.3e} (limit {r[tol]:g})")
        preset, model = parity._load_model(
            parity.build_parser().parse_args(inputs.argv(PARITY_GOLDENS)))
        pipe = inference.LaughterPipeline(
            model, feat_cfg=preset.feat,
            settings=inference.settings_from_flags(device="cuda", precision="float32"),
            device="cuda")
        card_probs = [pipe.probs_for_file(str(inputs.audio_dir / parity_inputs.MEETING
                                              / f"{chan}.wav"))[0]
                      for chan in parity_inputs.CHANNELS]
        margin = parity_inputs.check_margin(card_probs)
        print(f"parity CLI on {card} against the JAX goldens: 5 pass, 0 skipped; the smallest "
              f"margin of a card probability to a grid threshold {margin:.3e} (limit "
              f"{parity_inputs.MARGIN:g}); fbank launches: features {feature_launches[0]} "
              f"({n_files} files), the run {run_launches}; the conv epilogue "
              f"{EPILOGUES.by_path['parity_run']} in the run")

        # (c) laughs_to_wav on phase 4's TextGrid and audio.
        grid = work / "out" / f"t_{ctx['thr']}" / "l_0.2" / "meeting.TextGrid"
        intervals = textgrid.read_laughter_intervals(str(grid))
        cut = work / "laughs"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = laughs_to_wav.main(["--textgrid", str(grid), "--audio_file", str(ctx["wav"]),
                                     "--output_dir", str(cut), "--concat"])
        check(rc == 0 and intervals, f"laughs_to_wav: rc {rc}, {len(intervals)} intervals")
        lengths = []
        for i, (start, end) in enumerate(intervals):
            want_wave, _ = audio.read(str(ctx["wav"]), offset=start, duration=end - start)
            got, _ = audio.read_int16(str(cut / f"laugh_{i}_{start:.2f}-{end:.2f}.wav"))
            check(np.array_equal(got, (np.clip(want_wave, -1, 1) * 32767).astype(np.int16)),
                  f"laughs_to_wav: piece {i} ({start}-{end} s) is not its interval")
            lengths.append(len(got))
        concat, _ = audio.read_int16(str(cut / "all_laughs.wav"))
        gap = int(0.5 * 16000)
        check(len(concat) == sum(lengths) + gap * (len(lengths) - 1)
              and not concat[lengths[0]:lengths[0] + gap].any(),
              f"laughs_to_wav --concat: {len(concat)} samples for pieces {lengths}")
        print(f"laughs_to_wav: {len(intervals)} pieces equal to their intervals, all_laughs.wav "
              f"with {len(intervals) - 1} gaps of 0.5 s")

        # (d) probe_audio_loading on a shorten channel of phase 8's corpus.
        shn = ctx["corpus"][2]["Bmr013"][0]
        with contextlib.redirect_stdout(io.StringIO()) as text:
            rc = probe_audio_loading.main([shn, "--offsets", "0,10", "--duration", "5"])
        probed = text.getvalue().splitlines()
        check(rc == 0 and "shorten" in probed[0] and "decoder native" in probed[0],
              f"probe_audio_loading: rc {rc}: {probed}")
        print(f"probe_audio_loading: {' | '.join(probed)}")

        # (b) The demos' results.
        outs = {}
        for name, proc in demos.items():
            stdout, stderr = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"examples {name}: rc {proc.returncode}: {stderr[-3000:]}")
            outs[name] = stdout
        grids = sorted(demo_dir.glob("preds/dev/*/t_0.3/l_0.2/*.TextGrid"))
        check(len(grids) == 2 and "corpus-weighted evaluation:" in outs["demo"]
              and (demo_dir / "preds" / "dev_sum_stats.csv").is_file(),
              f"demo: {len(grids)} TextGrids; stdout ends {outs['demo'][-1500:]}")
        check("bit-identical to the offline pipeline" in outs["streaming"],
              f"streaming demo: {outs['streaming'][-1500:]}")
        featurized = int(re.search(r"\((\d+) fbank kernel launches\)", outs["demo"]).group(1))
        classified = int(re.search(r"inference: (\d+) fbank kernel launches", outs["demo"]).group(1))
        streamed = int(re.search(r"(\d+) fbank kernel launches\)", outs["streaming"]).group(1))
        check(featurized == 4 and classified == 2 * -(-10000 // 1024) and streamed >= 5,
              f"demos: fbank launches {featurized} featurizing 4 tracks, {classified} "
              f"classifying 2 x 100 s, {streamed} streaming 45 s")
        for name in demos:
            print(f"  {name}: " + " | ".join(ln for ln in outs[name].splitlines()
                                             if "launches" in ln or "bit-identical" in ln))
    finally:
        for proc in demos.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    print(f"phase 16 in {time.perf_counter() - t0:.1f} s on {card}")
    return {"parity_features": feature_launches[0], "parity_run": run_launches,
            "demo_features": featurized, "demo_inference": classified,
            "streaming_demo": streamed}


def worker_main(task: str, spec_path: str, rank: int) -> int:
    """One process of a phase-14 group: ``chip_smoke.py --worker TASK
    SPEC.json RANK``.  Tasks: ``dp`` (phase 14 (b): the recorded steps, the
    resident and streamed steps, the timings, an uninterrupted epoch and
    one that rank 1's SIGTERM stops), ``resume`` (that epoch resumed),
    ``cli`` (a CLI's ``main`` on the spec's argv plus the multi-process
    flags; prints its fbank launches) and ``nccl`` (NCCL with both
    processes on one card must refuse)."""
    import datetime
    import importlib
    import itertools
    import signal

    import torch

    sys.path.insert(0, str(REPO))
    from laughter_detection_icsi_tpu_torch.parallel import distributed

    spec = json.loads(Path(spec_path).read_text())
    join = dict(coordinator_address=f"file://{spec['store']}", num_processes=2, process_id=rank,
                device=spec["device"], timeout=datetime.timedelta(seconds=120))
    if task == "nccl":
        try:
            distributed.initialize(**join)
        except RuntimeError as e:
            if "--cpu_collectives gloo" not in str(e):
                raise
            print(json.dumps({"refused": str(e)}))
            return 0
        print("NCCL took two processes on one card")
        return 1
    if task == "cli":
        from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

        cli = importlib.import_module(f"laughter_detection_icsi_tpu_torch.cli.{spec['module']}")
        fbank_cuda.launches = 0
        rc = cli.main(spec["argv"] + ["--coordinator_address", join["coordinator_address"],
                                      "--num_processes", "2", "--process_id", str(rank),
                                      "--cpu_collectives", "gloo"])
        print(json.dumps({"launches": fbank_cuda.launches}))
        return rc

    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
    from laughter_detection_icsi_tpu_torch.data import FeatureCache, LadDataset, ResidentLadDataset
    from laughter_detection_icsi_tpu_torch.data.dataset import _epoch_slices
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.parallel import DataParallelTrainer
    from laughter_detection_icsi_tpu_torch.train import TrainLoop

    distributed.initialize(cpu_collectives="gloo", **join)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev, out = spec["device"], Path(spec["out"])
    batch, seed, epoch_seed = spec["batch"], spec["seed"], spec["epoch_seed"]
    preset = MODEL_MAP["resnet_base"]
    weights = torch.load(spec["weights"])
    ds = LadDataset(json.loads(Path(spec["rows"]).read_text()), FeatureCache(spec["feats"]))

    class Recording(DataParallelTrainer):
        def _update(self, grads, opt_state):
            self.grads = grads
            return super()._update(grads, opt_state)

    def trainer():
        m = zoo.build(preset.model, dropout_rate=0.5, linear_layer_size=preset.linear_layer_size,
                      filter_sizes=preset.filter_sizes)
        m.load_state_dict(weights, strict=True)
        return Recording(m, device=dev)

    def batches(**kw):
        return ds.batches(batch, seed=epoch_seed, drop_remainder=True, prefetch=0,
                          local_rows=(rank, 2), **kw)

    def loop_for(t, ckpt_dir):
        return TrainLoop(trainer=t, checkpoint_dir=str(ckpt_dir), write_artifacts=rank == 0,
                         sync_preempt=distributed.make_preemption_sync(), preempt_vote_every=2,
                         log_frequency=0)

    def host_ms(fn, iters=20):
        """Host clock over ``iters`` calls that end in a synchronize: a
        Gloo collective waits on the host, so the step cannot be queued
        ahead of the device."""
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        return 1e3 * (time.perf_counter() - t0) / iters

    cpu = lambda tensors: {k: v.detach().cpu().clone() for k, v in tensors.items()}
    report = {}
    if task == "dp":
        t, rec = trainer(), []
        opt = t.init()
        for k, b in enumerate(itertools.islice(batches(), spec["steps"])):
            pre = dict(sd=cpu(t.model.state_dict()), step=opt.step.cpu(), mu=cpu(opt.mu),
                       nu=cpu(opt.nu))
            opt, m = t.train_batch(opt, b, t.generator(seed, k))
            rec.append(dict(pre=pre, grads=cpu(t.grads), loss=float(m["loss"]),
                            post=cpu(t.model.state_dict())))
        if rank == 0:
            torch.save(rec, out / "steps.pt")
        b, gen = next(batches()), t.generator(seed, 9)
        report["step_ms"] = host_ms(lambda: t.train_batch(opt, b, gen))
        sizes, real = [], torch.distributed.all_reduce
        torch.distributed.all_reduce = lambda x, *a, **kw: sizes.append(x.numel()) or real(x, *a, **kw)
        try:
            t.train_batch(opt, b, gen)  # the collectives of one step, counted
        finally:
            torch.distributed.all_reduce = real
        report["collectives"], report["collective_floats"] = len(sizes), sum(sizes)
        small = torch.zeros(64, device=dev)
        report["small_ms"] = host_ms(lambda: torch.distributed.all_reduce(small))
        flat = torch.cat([g.reshape(-1) for g in t.grads.values()])
        report["grad_bytes"] = 4 * flat.numel()
        report["allreduce_ms"] = host_ms(lambda: torch.distributed.all_reduce(flat))
        sync = distributed.make_preemption_sync()
        report["vote_ms"] = host_ms(lambda: sync(False))

        res = ResidentLadDataset(ds, sharding=(rank, 2), pad_rows_to=2, device=dev)
        report["resident_rows"] = int(res.feats.shape[0])
        idx = _epoch_slices(len(ds), batch, True, epoch_seed, True)[0]
        report["gather_bytes"] = batch * (res.feats[0].numel() + 2) * 4
        report["gather_ms"] = host_ms(lambda: res.gather(idx))
        ta, tb = trainer(), trainer()
        _, ma = ta.train_batch_resident(ta.init(), res, idx, seed, 0)
        _, mb = tb.train_batch(tb.init(), next(batches()), tb.generator(seed, 0))
        sa, sb = ta.model.state_dict(), tb.model.state_dict()
        report["resident_vs_streamed"] = max(
            [abs(float(ma["loss"]) - float(mb["loss"]))]
            + [(sa[n].float() - sb[n].float()).abs().max().item() for n in sa])

        t = trainer()
        loop = loop_for(t, out / "whole")
        opt, _ = loop.run_epoch(t.init(), batches(), seed=seed, verbose=False)
        loop.save(opt)

        def signalling(it):
            for i, b in enumerate(it):
                if rank == 1 and i == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b

        t = trainer()
        loop = loop_for(t, out / f"cut{rank}")
        loop.install_preemption_handler()
        loop.run_epoch(t.init(), signalling(batches()), seed=seed, verbose=False)
        report["stopped"] = [loop.global_step, loop.preempted]
    elif task == "resume":
        t = trainer()
        loop = loop_for(t, out / f"cut{rank}")
        opt = distributed.sync_resume(loop, loop.resume_if_possible(t.init()))
        report["resumed_at"] = loop.global_step
        opt, _ = loop.run_epoch(opt, batches(skip_assembly=loop.epoch_step), seed=seed,
                                verbose=False)
        loop.save(opt)
    else:
        raise ValueError(f"unknown worker task {task!r}")
    torch.distributed.destroy_process_group()
    print(json.dumps(report))
    return 0


def train_breakdown(what: str, step, trace_path: Path, steps: int = 5):
    """Profile ``steps`` train steps (torch.profiler) and print the device's
    busy share of their wall and its time by region (the Trainer's
    'train/forward', 'train/backward', 'train/optimizer' annotations) and
    kind (cuDNN convolutions, everything else).  A kernel belongs to the
    region whose host range holds its launch (matched by correlation id).
    Returns the busy share (None when the profiler recorded no device
    activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        print(f"  train step breakdown ({what}): not measured (no device activity recorded)")
        return None
    regions = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith("train/"))
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    table, busy_us, end = {}, 0.0, -math.inf
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        region = next((n for a, b, n in regions if ts is not None and a <= ts <= b), "other")
        kind = "convs" if kernel_kind(e["name"]) in ("convs", "layout") else "the rest"
        table[(region, kind)] = table.get((region, kind), 0.0) + float(e["dur"]) / 1e3
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    total = sum(table.values())
    print(f"  profiled {steps} steps ({what}): wall {wall_ms:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms = {100 * busy_us / 1e3 / wall_ms:.1f}%, device time "
          f"{total:.2f} ms = {total / steps:.3f} ms a step:")
    for (region, kind), ms in sorted(table.items(), key=lambda kv: -kv[1]):
        print(f"    {region:16s} {kind:9s} {ms / steps:8.3f} ms a step = {100 * ms / total:5.1f}%")
    return busy_us / 1e3 / wall_ms


#: Phase 17's meeting: 130 s on two channels, three bucket batches of the
#: AST preset's 6,000 frames, the last partial.
CLIPS_CORPUS = (("Bmr013", 2, 130, "pcm"),)


def phase_clips(card, work: Path) -> int:
    """The AST preset on the main path: ``cli/sweep.main --config
    ast_audioset --random_init`` over ``CLIPS_CORPUS`` on card 0 in the
    card's default bf16 (see the module docstring, phase 17).  Returns the
    fbank launches of the run."""
    import contextlib
    import io

    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli import sweep
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP, parse_float_list
    from laughter_detection_icsi_tpu_torch.data import audio
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

    tdir, adir, paths = write_sweep_corpus(work / "clips_corpus", work / "clips_cache",
                                           CLIPS_CORPUS)
    ((meeting, chans),) = paths.items()
    preset = MODEL_MAP["ast_audioset"]
    settings = inference.settings_from_flags(device="cuda", mode=preset.mode)
    t = max(host_prep.num_frames(audio.info(p).num_samples, preset.feat) for p in chans)
    batches = -(-t // settings.bucket_frames)
    grid = (len(parse_float_list(sweep.DEFAULT_THRESHOLDS))
            * len(parse_float_list(sweep.DEFAULT_MIN_LENGTHS)))
    out = work / "sweep_clips"
    text = io.StringIO()
    clips_before = inference.clips_classified
    fbank_cuda.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = sweep.main(["--audio_dir", str(adir), "--transcript_dir", str(tdir),
                         "--output_dir", str(out), "--split", "all", "--analyse",
                         "--config", "ast_audioset", "--random_init", "--device", "cuda:0"])
    torch.cuda.synchronize()
    launches = fbank_cuda.launches
    took = time.perf_counter() - t0
    clips = inference.clips_classified - clips_before
    check(rc == 0, f"AST sweep returned {rc}: {text.getvalue()[-800:]}")
    # One launch a bucket batch, and the warm-up's bucket batch of zeros.
    check(launches == batches + 1,
          f"AST sweep: {launches} fbank launches for {batches} bucket batches + the warm-up")
    per_launch = len(chans) * settings.bucket_frames // settings.hop_frames
    check(clips == launches * per_launch,
          f"AST sweep: {clips} clips classified, {launches} x {per_launch} owed")
    grids = sorted((out / "all" / meeting).rglob("*.TextGrid"))
    check(len(grids) == len(chans) * grid, f"AST sweep: {len(grids)} TextGrids")
    print(f"AST sweep of {meeting} ({len(chans)} x {CLIPS_CORPUS[0][2]} s, {t} frames, bf16, "
          f"seeded weights): rc 0 in {took:.1f} s; {launches} fbank launches ({batches} bucket "
          f"batches of {settings.bucket_frames} frames + the warm-up), {clips} clips, "
          f"{len(grids)} TextGrids")
    return launches


def main(through: int = 17) -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAILED: PyTorch is missing ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (REPO / "laughter_detection_icsi_tpu_torch").is_dir():
        print(f"chip_smoke: FAILED: no laughter_detection_icsi_tpu_torch package beside "
              f"{Path(__file__).name}; run it from a checkout", file=sys.stderr)
        return 2
    work = REPO / "build" / "chip_smoke" / "run"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_start = time.perf_counter()
    header = lambda name: print(f"== {name} == ({time.perf_counter() - t_start:.1f} s in)", flush=True)
    try:
        header("1. device")
        card, kind, peak = phase_device()
        header("2. build")
        block_frames = phase_build()
        header("3. the kernels vs their plain versions")
        entry = phase_kernel(card, peak, block_frames)
        epilogue = phase_epilogue(card, peak)
        header("4. main path")
        ctx = phase_main_path(card, work)
        header("5. fused_conv")
        fused = phase_fused_conv(card, work, ctx)
        header("6. streaming and serve")
        streamed = phase_streaming(card, work, ctx)
        header("7. multichannel")
        ctx["work"] = work
        batched = phase_multichannel(card, work, ctx)
        if through == 7:
            print(f"phases 1-7 passed in {time.perf_counter() - t_start:.1f} s (--through 7: "
                  f"no result line)")
            return 0
        header("8. corpus sweep")
        ctx["cache"] = work.parent / "cache"
        swept = phase_sweep(card, work, ctx)
        header("9. training")
        trained = phase_train(card, work, ctx)
        header("10. training from a corpus")
        featurized = phase_corpus_train(card, work, ctx)
        header("11. bf16 serving")
        bf16 = phase_bf16_serving(card, work, ctx)
        header("12. bf16 training")
        phase_bf16_train(card, work, ctx)
        header("13. export")
        artifact = phase_export(card, work, ctx)
        header("14. multi-process")
        multi = phase_multiprocess(card, work, ctx)
        header("16. parity, demos and tools")
        tools = phase_parity(card, work, ctx)
        header("17. AST clips sweep")
        clips = phase_clips(card, work)
    except Exception as e:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    by_path = {"windows": ctx["launches"], "fused_conv": fused, "serve": streamed,
               "multichannel": batched, "multichannel_two_shards": ctx["mc_shard_launches"],
               "sweep": swept["launches"],
               "sweep_packed": swept["packed"], "sweep_fused_conv": swept["fused"],
               "training_features": trained, "compute_features": featurized["launches"],
               **bf16, "e2e_artifact": artifact,
               **{f"multiprocess_sweep_rank{r}": n for r, n in enumerate(multi["sweep"])},
               **{f"multiprocess_train_features_rank{r}": n for r, n in enumerate(multi["train"])},
               **tools,
               "sweep_clips_bf16": clips}
    print(f"fbank launches per path: windows {ctx['launches']} ({ctx['n_buckets']} buckets), "
          f"fused_conv {fused} (one file), serve replay {streamed} ({ctx['n_buckets']} buckets "
          f"+ warm-up), multichannel {batched} (bucket batches of 4 channels) and "
          f"{ctx['mc_shard_launches']} on two shards of the card, corpus sweep "
          f"{swept['launches']} (raw), {swept['packed']} (packed), {swept['fused']} (fused_conv), "
          f"training features {trained}, compute_features {featurized['launches']} (30,000-frame "
          f"buckets); bf16: windows {bf16['windows_bf16']}, fused_conv {bf16['fused_conv_bf16']}, "
          f"serve replay {bf16['serve_bf16']}, multichannel {bf16['multichannel_bf16']}, sweep "
          f"{bf16['sweep_bf16']}; the e2e artifact {artifact} ({ctx['n_buckets']} buckets); "
          f"two processes: the sweep {multi['sweep']} by rank (each its 2 channels' bucket "
          f"batches + a warm-up), cli/train's featurization {multi['train']} by rank (rank 0 "
          f"first, rank 1 after the barrier); the parity CLI's features check "
          f"{tools['parity_features']} (one a file) and its whole run {tools['parity_run']}; "
          f"the demo {tools['demo_features']} featurizing and {tools['demo_inference']} "
          f"classifying, the streaming demo {tools['streaming_demo']}; the AST sweep {clips} "
          f"(bucket batches + the warm-up)")
    entry["max_abs_err"] = max(entry["max_abs_err"], swept["max_err"], featurized["max_err"])
    entry = {"name": entry.pop("name"), "route": entry.pop("route"),
             "source": entry.pop("source"), "replaces": entry.pop("replaces"),
             "launches": swept["launches"], **entry, "launches_by_path": by_path}
    by_path = EPILOGUES.by_path
    print("conv epilogue launches per path (each the convs its classify steps run): "
          + ", ".join(f"{k} {v}" for k, v in by_path.items()))
    print("of them padded (each the band convs whose result the next band conv reads): "
          + ", ".join(f"{k} {v}" for k, v in EPILOGUES.padded_by_path.items()))
    epilogue = {**{k: epilogue.pop(k) for k in ("name", "route", "source", "replaces")},
                "launches": by_path["sweep_bf16"], **epilogue, "launches_by_path": by_path,
                "padded_by_path": EPILOGUES.padded_by_path}
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [entry, epilogue]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:  # one process of phase 14's groups
        sys.exit(worker_main(sys.argv[2], sys.argv[3], int(sys.argv[4])))
    if sys.argv[1:] == ["--through", "7"]:  # phases 1-7: phase 7 (b) on a several-card host
        sys.exit(main(through=7))
    if sys.argv[1:]:
        sys.exit(f"usage: {sys.argv[0]} [--through 7]")
    sys.exit(main())
