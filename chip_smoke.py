#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to account.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   the card's name and power limit (nvidia-smi), CUDA version, and
            the time to build the rANS kernels (nvcc) and the container
            state chain (g++), built in parallel from csrc/.
2. depth    the latency of one step's irreducible chain on the card: a
            one-warp probe runs the decode step (one CDF evaluation and the
            64-bit multiply-add) and the encode step (reciprocal division
            and multiply-add) back to back; k times it is a kernel's serial
            depth floor, `depth_bound_ms`.
3. kernels  the three rANS kernels against their plain PyTorch versions on
            the same CUDA tensors at the flagship level shapes (S=384, k=256
            and S=768, k=64), with and without bits-back seeds, with
            out-of-window symbols: prepass records, words, flags, states and
            decoded values must be bit-identical, and the decode must return
            the input with every state back at 2^32 | seed.  Then C=4
            containers in one launch each way against 4 plain calls, and a
            decode of a random (corrupt) buffer against the plain decode.
4. e2e      the main path at full width: FlowCodec over the flagship IDFlow
            (64x64x3, nflows 8, nsplit 3, DenseBlocks of growth 512 and
            depth 12), random weights from a seed with every projection
            perturbed off zero, compress_many then decompress_many(fetch=True)
            on a queue of 4 batches of 16 images; bit-exact, with launch
            counts taken over exactly that run (one launch of each coding
            kernel per level); then a torch.profiler pass over one more
            queue (device time by kernel, idle share, and the rANS
            launches it recorded on the device, which must equal the
            counts).  The codec runs at its default granularity on the
            card, "fused" (a CUDA graph per direction: the first warm-up
            pass runs eagerly, the second captures); the level path's
            images/s stand beside it.
4b. fused   the fused granularity against the level path at full width:
            the flagship 16 x 2 queue through FlowCodec(granularity=
            "fused") and "level": containers byte-identical, fused encode
            -> level decode and level encode -> fused decode bit-exact,
            one launch of each coding kernel per level in the eager first
            call, the capturing second call (the capture counts none;
            its replay does) and a replayed pass, wall and images/s of
            each mode, the fused mode's idle share (profile pass `fused_profile`,
            recording the launches on the device), capture seconds
            and the graph pool's bytes, and two
            decompress_many(fetch=False) results held across each other's
            replay (the aliasing check).  An outlier queue (pixels +40,
            far outside the window), decoded twice: with MAX_OUTLIERS 4
            the level path decodes it (counted in level_fallbacks), with
            the default 256 the second call's graph patches the escapes;
            all bit-exact.  Then the residual codec (16 x 2)
            and TwoLevelCodec(granularity="fused") (2 x 4), each
            byte-identical to its level mode and bit-exact both ways.
5. train    the training path at full width: the port's cli.train
            (`load_config`, its own YAML reader, then `build_trainer`) on
            configs/imagenet64.yaml's model (the flagship IDFlow, batch 16,
            steps_per_dispatch 4, Adamax 1e-3 with WarmUp 10 / 0.99), its
            two dataloaders overridden to NaturalSynthetic 64x64x3 (no
            ImageNet64 in the repository), epochs of 8 steps, 12 steps as
            three K-step blocks of the captured K-step graph (the first
            block eager, the second captured and replayed, the third
            replayed: the learning rate changes between them), eval with
            real rANS coding of one batch at step 8, checkpoint
            and resume.  FLOPs per step (FlopCounterMode), peak memory, bpd
            on one fixed batch before and after, the evals' coded bpd and
            errors, the rANS launches of each eval, whether a trainer
            resumed from the checkpoint holds the same params, optimizer
            state and step.  Then `against_eager`: a trainer built from
            the same config runs the same 12 steps through the K-step
            step's eager body, and the captured trainer must equal it
            (params, optimizer moments and step counters, update count:
            bit for bit), the learning rates each replay
            read (different across replays, the schedule's), then one
            replayed block against one eager one: step time, images/s,
            MFU against the H100's float32 peak and, from torch.profiler
            over the replayed block, the device's busy time and idle share;
            captures, capture seconds and the graph pool's bytes.  Phases
            8, 9, 11 and 14 and the one NCCL rank of phase 17 run their
            trainers captured the same way.
6. cli      the file codec CLI's serve session (`cli.codec`) on
            configs/imagenet64.yaml's model at full width, from a checkpoint
            of seeded weights with perturbed projections that the phase
            writes (under logs/chip_smoke_cli, removed at the end): 5 .npy
            files of 64x64x3 and one of 150x200x3 (12 tiles: chunks 8 + 4)
            compressed three times and decompressed three times (the first
            command of the layout runs eagerly, the second captures its
            CUDA graph, the third replays it) with the stored escape off,
            then a 5x6x3 file and a 64x64x3 one compressed with it on
            (the 5x6 must take the escape: stored-png where PIL is
            installed, stored-zlib where not) and decompressed in one
            command with a flow container of the first session (stored and
            flow entries mixed); every file bit-exact, one launch of each
            coding kernel per chunk layout per level in each command's
            direction.  Then the warm commands again with the codec at
            granularity "level" (the same .lic bytes), and the fused
            warm pair profiled (`cli_profile_fused`, 9 launches of each
            kernel recorded on the device).  A serve
            session of new chunk layouts (4 and 5 one-tile files, compress
            and decompress each) in each mode: the fused codec captures
            nothing.  Then `cli_one_shot`: per granularity (fused, level)
            a CLI process of its own compresses and decompresses the 6
            files, each the first command of its layout in the process,
            as a one-shot command is (process and command seconds).
            Startup seconds, each command's `ok` seconds and rANS
            launches, the CLI's TIMER phases, bytes and bpd per mode,
            files/s and tiles/s, capture seconds and graph pool bytes.
7. residual the VQ-VAE residual pipeline at full width:
            configs/resflow-cond-imagenet64.yaml (ConditionalFlows with
            conv_for_cond, coupling DenseBlocks 384 x 8, prior 512 x 12,
            LeakyReLU; VQ-VAE 8192 x 512, hidden dims 128/256/512, 8
            ResBlocks), seeded weights, projections perturbed.
            ResidualCodec.compress_many / decompress_many(fetch=True) on a
            queue of 4 batches of 16 images, bit-exact, one launch of each
            rANS kernel per level; real_bpd split into index and residual
            bits; a phase split fenced with synchronize (VQ encode,
            reconstruction, flow encode, pack, decode); then
            `residual_profile` (torch.profiler over one more queue), and
            4 files through the CLI with this config (`residual_cli`), the
            VQ checkpoint written by the phase: compressed in this process
            and decompressed in a new one, bit-exact.
8. vqvae_train  configs/vqvae_for_imagenet64_reinit.yaml at full width
            through cli.train (VQ-VAE 8192 x 512, hidden dims 128/256/512,
            8 ResBlocks, Binomial, Adam 1e-4, batch 32) on NaturalSynthetic
            64x64x3: 6 captured steps (update, usage counts and dead-code
            reinit in one graph; the reinit's interval cut to 2 so that it
            fires) over epochs of 4 steps, eval of one batch, checkpoint
            and resume, `against_eager` (counts, codebook, replaced count
            and the BatchNorm running averages included).  Step time,
            images/s, MFU, peak memory, codewords replaced.
9. residual_train  configs/resflow-cond-imagenet64.yaml at full width
            through cli.train, its VQ-VAE the checkpoint phase 8 wrote,
            projections perturbed: 6 captured steps at batch 4, each on 2
            of the batch's 4 patches drawn by the trainer's generator
            outside the graph, epochs of 4 steps, eval of one batch coded
            for real through ResidualCodec at step 4 (0 errors, one
            launch of each kernel per level each), MFU, peak memory,
            resume, `against_eager` (the generator's state included); then
            cli.make_res_data on two batches (residual + reconstruction is
            the data exactly, the reconstruction on the 1/256 grid).
10. twolevel configs/config_twolevel.yaml's model at full width (215x178
            padded to 216x184, rough flow 27x23, fine flow over 621 8x8
            tiles per image, DenseBlocks growth 512 depth 8, nflows 12),
            seeded weights, projections perturbed: TwoLevelCodec
            compress_many / decompress_many(fetch=True) on a queue of 2
            batches of 4 NaturalSynthetic images, bit-exact, one launch of
            each kernel per sub-flow, the DenseLayer kernel's narrow
            geometry launched once for each fine-flow layer (104 a batch a
            direction) and for no rough one; then `twolevel_profile`.
11. twolevel_train  the same config through cli.train at batch 4: 6
            captured steps (the fine flow's recomputation in the graph's
            backward) over epochs of 4 steps, eval of one batch coded
            through TwoLevelCodec at step 4 (0 errors), FLOPs, MFU,
            peak memory, samples at four temperatures, resume,
            `against_eager`.
12. twolevel_cli  phase 10's model through the file CLI: two 215x178 files
            and a 300x200 one (4 tiles, one chunk) compressed in a serve
            session and decompressed by the CLI in a process of its own
            (`python -c CLI_CHILD`, which prints its launch counts),
            bit-exact, one launch of each kernel per sub-flow per chunk
            size.  Phases 8-12 write under logs/chip_smoke_pipelines,
            removed at the end.
   paths    phase 3's kernel checks at every other (S, k, seeded) shape
            that phases 4, 6, 7, 9, 10, 12 and 16 coded with (each codec's
            own stream policy over its batch sizes: the CLI's chunks of 1,
            8 and 4 tiles, the two-level sub-flows' rough images and fine
            tiles), so every launch shape of every path is held against
            the plain coder.
13. large   an 8M-symbol message (S=8192, k=1024): the kernels against their
            plain versions as in phase 3 (each plain version run once, its
            checking call timed: the plain decode takes seconds), then the
            whole encode and decode timed, bit-exact.
14. finetune  configs/config-trans-test.yaml at full width through
            cli.train (the Finetuner: 64x48x3, nflows 8, nsplit 3,
            DenseBlocks 512 x 12, batch 16, the config's Adamax 1e-3 with
            WarmUp 10 / 0.99 over epochs of 4 steps in place of the
            constant fine_tune_lr, so the learning rate changes), its
            load_path a checkpoint of phase 4's seeded weights (a flow's
            weights do not depend on H, W), both loaders on
            NaturalSynthetic 64x48: 8 captured tuning steps saving every 4
            (the model bit-identical after them, the tuner nonzero), a
            resume that restores tuner, optimizer state and step,
            `against_eager`, then 3 steps with fine_tune off (tuner zero,
            no checkpoint).  Step time, images/s, FLOPs (input gradients
            only), MFU, peak memory, bpd.
15. visualize  cli.visualize on configs/vis_config_imagenet64.yaml at full
            width (the flagship 64x64 flow, the same checkpoint): grids of
            16 samples at temperatures 0.25-1.0, each held to the identity
            forward(sample) == the latents the sampler drew, exactly; an
            8 x 8 interpolation between four NaturalSynthetic corners.
            Seconds per grid.
16. padded  phase 4's weights zero-padded by pad_growth_params to growth
            multiples 16 and 64 (48 and 64 channels per 3x3 conv against
            42-43): the same 4 x 16 queue compressed and decompressed,
            bit-exact, one launch of each kernel per level; images/s, idle
            share, the convolutions' device ms (`padded_profile_<m>`)
            against phase 4's profile of the unpadded model, latents that
            differ from the unpadded model's (reported); its launch shapes
            then go through `paths`.  Phases 14-16 write under
            logs/chip_smoke_tools, removed at the end.
17. scaleout  the port's scale-out (parallel/, cli/scaling.py) in
            spawned processes, each rank's kernels counted in its own
            process (one card: NCCL refuses two ranks on it, so the
            two-rank parts ask for gloo, its collectives staged through
            the host).  (a) one NCCL rank: ShardedFlowCodec on the
            flagship at batch 16, its 3 containers byte-identical to
            FlowCodec.compress of the batch, bit-exact, 3 launches each
            way; three sharded train steps of configs/imagenet64.yaml's
            model, captured (eager, capture, replay), equal to three plain
            eager steps bit for bit; beside it parallel/multiproc.py's
            launcher at its default (NCCL, a card a rank) with one rank,
            4 steps, its containers reproduced by its reference coder and
            its collective time read from the device.  (b) two gloo
            ranks on the card: ShardedFlowCodec (flagship, 32 images),
            ShardedResidualCodec (resflow-cond-imagenet64, 16 images),
            ShardedTwoLevelCodec (config_twolevel, 4 images), each rank's
            containers and VQIX stream byte-identical to this process's
            single-process compress of its shard, every decode bit-exact,
            3 / 3 / 2 launches per rank each way; the sharded Trainer
            (cli.train.build_trainer on configs/imagenet64.yaml, use_mesh,
            shard: true, local batch 16, 4 steps as two blocks of K = 2,
            then eval coded through ShardedFlowCodec): parameters equal on
            both ranks, 0 coding errors, step time, images/s, collective
            host ms per step; the sharded VQ search at 8192 x 512 over
            mesh (1, 2) equal to the dense argmin on the card.  (c)
            cli/scaling.py's command line with two gloo ranks on the card
            (spawned; default widths, 3 timed steps), overhead and weak
            mode at 1 and 2 ranks, collective host ms, weak scaling on
            hardware stamped unmeasured, the artifact read back; beside
            it (d) the launcher with two gloo ranks on the card and its
            reference coder (the two share the card, so their times are
            no measurement of either alone).  Its launch shapes then go
            through `paths`; files under logs/chip_smoke_scaleout, removed
            at the end.

18. demo  the port's demo harnesses (`demo/`) on configs/synthetic64.yaml
            at full width (nflows 8, nsplit 3, DenseBlocks 256 x 6, batch
            32, K = 4): cli.train for 200 captured steps (the training set
            cut to 2048 of its 8192 images; the phase prints the cut),
            eval with real coding at step 200 (0 errors) and the train bpd
            over steps 181-200 beside the JAX package's run
            (results/synthetic64_metrics.jsonl); then demo.filecodec_demo
            with that checkpoint over the in-domain corpus (arrays) and
            demo/corpus/ with PIL hidden (its PNGs through the package's
            PNG reader, held against PIL's decode where PIL imports; the
            stored escape stored-zlib): cold and warm one-shot commands
            and a serve session, every file bit-exact, each command's
            launches; then
            demo.stress at 50M symbols (S = 8192, k = 6112): host in the
            loop and kernel paths bit-exact, the decode windowed, coded
            bits per symbol within 0.001 of results/stress_50m_r05.json;
            then the three kernels against their plain versions on that
            message (each plain version run once: the stress's own plain
            path is left out), a row of the kernels line, and `paths` at
            the path's other launch shapes.  Files under
            logs/chip_smoke_demo, removed at the end.
19. bench   the measurement harnesses at the flagship: `bench.main` in
            bfloat16 (its default) and with --f32, at cut iters, train
            steps, windows and queue (BENCH_CUT: 16 x 2; the f32 run's
            coder messages cut to 131,072 symbols): e2e images/s (fused,
            replayed)
            beside level, bit-exact on every pass, real and analytic bpd,
            the phase split, idle share of a profiled pass (its recorded
            rANS launches equal to the wrappers' 3 each), latency, the
            train step's host and device times and MFU against the
            dtype's peak, the coder at 1.2M symbols (S = 8192, k = 144)
            and 8M (the plain path once), the host C++ baseline; the two
            dtypes' containers must differ.  Then
            `demo.serving_roofline` at 8192 streams, 16 x 2 (the NN
            inverse exact, the bf16 probe exact) and
            `demo.mfu_roofline_padded`'s
            function check at multiple 16 (latents that differ counted,
            the padded codec exact); `paths` at the new launch shapes.
20. multichip  `demo.multichip` (the port's `__graft_entry__`) at JAX's
            parity size as one NCCL rank on the card, in a process of its
            own (`--nproc 1`) that runs beside phase 17(b), its record
            printed here: the sharded residual train step captured
            and timed, checked against its eager twin and the plain step;
            the sharded VQ search; chip-local rANS, ShardedFlowCodec
            ("fused") and ShardedResidualCodec, each byte-identical to a
            "level" codec's encode of the rank's shard and exact; the
            kernels against their plain versions at every shape they
            launched at, as the rank counted its launches; `paths` at
            those shapes and at the raw rANS shape of the full-width run
            (S = 3072, k = 64).  Its full width (configs/resflow-cond-
            imagenet64.yaml) over four NCCL ranks, a card each, is
            `chip_demo_run.sh OUTDIR multichip`.

Then the `kernels` summary line (`launches_fused`: phase 4b's counts by
codec and case; `launches_profiled`: the launches the profiler recorded
on the device in the profiled passes of phases 4, 4b, 6, 7 and 16;
`launches_scaleout`: phase 17's counts by part, rank and direction;
`launches_demo`: phase 18's by command; `launches_bench`: phase 19's
by run; `launches_multichip`: phase 20's by part and direction), the
nvidia-smi line, and last {"ok": true, "device": {...}}.  Any failure
raises and exits non-zero; with no CUDA device, or outside the
repository, it exits non-zero and prints no result.  `--quick` runs
phases 1-3 only.

3b. dense   the DenseLayer kernel (ops/dense_conv.py) at every launch
            shape of the published flows' inference passes (imagenet64 at
            batch 16, resflow-cond-imagenet64's conditional flow at batch
            4, config_twolevel's rough and fine sub-flows at batch 4; the
            fine 4x4 tiles take the narrow geometry, every other shape the
            wide one) and at four narrow shapes no model launches (W 2 and
            1, an odd H, g 100), recorded from the calls: against its plain
            version
            (float32, tolerance 1e-4 of the output's largest magnitude:
            sums of up to 9 x 520 products in another order), two launches
            bit-identical, the buffer's other channels untouched (its
            unused channels hold NaN, which the kernel must never read);
            device ms of the kernel, the plain version and F.conv2d on
            cuDNN (`library_ms`), each as CUDA graphs of back-to-back
            calls, beside the bound at 67 TFLOP/s on the FLOPs the fused
            layer does.  Then the fused FlowCodec round trip of 4 x 16
            images bit-exact with the kernels' launch counters' change over
            one replayed pass equal to 12 layers x 9 blocks x 3 levels x 4
            batches x 2 directions (and the split-K reduces the shapes
            predict, and no narrow launch), and one captured train call
            launching neither.
            `--dense` runs phases 1 and 3b only.
"""

import contextlib
import copy
import importlib.util
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from finalproject_losslessimagecompression_tpu_torch.bench import (  # noqa: E402,E501
    clamped_message,
    coded_shapes,
    max_err,
    message,
    perturbed,
)
from finalproject_losslessimagecompression_tpu_torch.utils.profiling import (  # noqa: E402,E501,F401 (chip_profile_read.py reads kernel_times here)
    kernel_times,
    profile_busy,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
CDF_FLOPS = 10  # float32 ops of one CDF evaluation (codec/cdf.py)
SOURCE = "finalproject_losslessimagecompression_tpu_torch/csrc/rans_kernels.cu"
ENC = ["rans_cdf_prepass_kernel", "rans_encode_kernel"]
DEC = ["rans_decode_kernel"]
TPU_KERNELS = "finalproject_losslessimagecompression_tpu/codec/pallas_rans.py"


def kernel_wrappers():
    """The kernel wrappers by kernel name, each with its launch count."""
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        cuda_rans,
    )

    return {"rans_cdf_prepass_kernel": cuda_rans.rans_cdf_prepass,
            "rans_encode_kernel": cuda_rans.rans_encode,
            "rans_decode_kernel": cuda_rans.rans_decode}


T0 = time.time()
_LAST = [T0]  # when the previous phase record was printed


def emit(obj):
    """Print a record as one JSON line.  A phase's record carries `t_s`,
    the seconds since the script started, and `phase_s`: its own, where
    the phase timed itself, else the seconds since the previous phase
    record (the work that made this one)."""
    if "phase" in obj:
        now = time.time()
        obj = {**obj, "t_s": now - T0}
        obj.setdefault("phase_s", now - _LAST[0])
        _LAST[0] = now
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int, names) -> float:
    """Device time per call of fn, which launches each kernel named in
    `names` once: the sum over those kernels of their mean time per
    recorded launch (torch.profiler, kernels only), so that the time of a
    short kernel is not the host's time between launches, and a launch
    the trace did not record does not lower the mean.

    A trace that recorded no launch of a kernel is taken again: the
    profiler can drop every record of a short kernel in a session, and
    after the phases' own profiler sessions it has done so three times
    running.  Then the time is CUDA events around `reps` back-to-back
    calls (an upper bound: it holds the host's gaps between launches),
    and a `device_ms_fallback` line says which kernels it covers."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_name = [[e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and name in e.key and e.count > 0] for name in names]
        if all(per_name):
            return sum(sum(e.self_device_time_total for e in events)
                       / sum(e.count for e in events) / 1e3
                       for events in per_name)
    ms = cuda_ms(fn, reps)
    emit({"phase": "device_ms_fallback", "kernels": list(names),
          "not_recorded": [n for n, ev in zip(names, per_name) if not ev],
          "event_ms": ms})
    return ms


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and float32
    operations over the float32 peak."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device():
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        container,
        cuda_rans,
    )

    t0 = time.time()
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)

    builds = [threading.Thread(target=run, args=(f,))
              for f in (cuda_rans.build, container._chain)]
    for th in builds:
        th.start()
    for th in builds:
        th.join()
    if errors:
        raise errors[0]
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": round(time.time() - t0, 3)})
    return smi


# ---------------------------------------------------------------------------
# phase 2: the serial depth floor
# ---------------------------------------------------------------------------


def phase_depth(steps: int = 1 << 15):
    """Nanoseconds per step of each coder's irreducible chain (one warp,
    `steps` dependent steps, CUDA events)."""
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        cuda_rans,
    )

    out = torch.empty(32, dtype=torch.int64, device="cuda")
    ns = {kind: cuda_ms(lambda: cuda_rans.depth_probe(kind, steps, out), 3)
          * 1e6 / steps for kind in cuda_rans.DEPTH_PROBES}
    emit({"phase": "depth", "steps": steps, "ns_per_step": ns})
    return ns


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def random_seeds(shape, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 2**32, shape, generator=g, device="cuda",
                         dtype=torch.int64)


def cuda_once(fn):
    """(fn's result, its device time in ms) of one call (CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def kernel_case(S: int, k: int, seeded: bool, seed: int, depth_ns,
                inputs=None):
    """The three kernels against their plain versions on one [k, S]
    message: `clamped_message(S, k, seed)`, or `inputs` (window-clamped
    bins, means, scales, lower bounds).  Each plain version runs once, its
    checking call timed (CUDA events; a plain decode takes from a tenth
    of a second to tens of seconds)."""
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        interleaved as IL,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.cdf import (
        NBINS,
        cdf_bits,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.cuda_rans import (
        cdf_eval,
        rans_cdf_prepass,
        rans_decode,
        rans_encode,
    )

    dev = torch.device("cuda")
    n = S * k
    vc, m, s, lower = (clamped_message(S, k, seed, "cuda") if inputs is None
                       else inputs)
    plain = {}

    def checked(name, fn):
        out, plain[name] = cuda_once(fn)
        return out
    seeds = random_seeds((S,), seed) if seeded else None

    # the kernels' CDF against torch's on the card, at the coded bins and
    # at random window positions
    pos = torch.cat([vc - 1, vc, lower - 1 + torch.randint(
        0, NBINS + 1, vc.shape, device=dev, dtype=torch.int32)]).reshape(-1)
    rep = lambda t: t.reshape(-1).repeat(3)  # noqa: E731
    ck = cdf_eval(pos, rep(m), rep(s), rep(lower))
    ct = cdf_bits(pos.reshape(-1), rep(m), rep(s), rep(lower))
    cdf_agree = float((ck == ct).float().mean())
    # the kernels are held to the plain coder bit for bit, which needs the
    # same CDF on both sides: any disagreement is a fault of this build
    assert cdf_agree == 1.0, (
        f"kernel CDF agrees with cdf_bits on only {cdf_agree:.6f} of "
        f"evaluations (S={S}, k={k})")

    rk = rans_cdf_prepass(vc, m, s, lower)
    rp = checked("prepass", lambda: IL.cdf_prepass_plain(vc, m, s, lower))
    pre_err = max_err([(rk, rp)])
    assert pre_err == 0, f"prepass kernel differs from plain (S={S}, k={k})"
    c_start, freq, _ = IL.unpack_prepass(rk)
    assert all(torch.equal(a, b) for a, b in zip(
        (c_start, freq), IL.cdf_tiles(vc, m, s, lower)))

    wk, fk, hk, lk = rans_encode(vc, m, s, lower, seeds)
    wp, fp, hp, lp = checked(
        "encode", lambda: IL.encode_plain(vc, m, s, lower, seeds))
    enc_err = max_err([(wk, wp), (fk, fp), (hk, hp), (lk, lp)])
    assert enc_err == 0, f"encode kernel differs from plain (S={S}, k={k})"

    buf, total = IL.compact(wk, fk)
    vk, h2, l2 = rans_decode(buf, total, hk, lk, m, s, lower)
    assert torch.equal(vk, vc), "decode kernel did not return the input"
    assert bool((h2 == 1).all()), "decode kernel: hi did not return to 1"
    want_lo = seeds if seeded else torch.zeros_like(l2)
    assert torch.equal(l2, want_lo), "decode kernel: lo did not return"
    vp, h3, l3 = checked(
        "decode", lambda: IL.decode_plain(buf, total, hk, lk, m, s, lower))
    dec_err = max_err([(vk, vp), (h2, h3), (l2, l3)])
    assert dec_err == 0, f"decode kernel differs from plain (S={S})"
    del rp, wp, fp, hp, lp, vp, h3, l3

    # kernels: device time from the profiler; plain versions (hundreds of
    # small torch kernels each): their checking calls, CUDA events around
    pre_ms = device_ms(lambda: rans_cdf_prepass(vc, m, s, lower), 20,
                       ["rans_cdf_prepass_kernel"])
    enc_ms = device_ms(lambda: rans_encode(vc, m, s, lower, seeds), 20,
                       ENC)
    dec_ms = device_ms(lambda: rans_decode(buf, total, hk, lk, m, s, lower),
                       20, DEC)
    # cross-check: CUDA events around back-to-back calls (the decode is
    # long enough that the host's time between launches hides in it)
    dec_event_ms = cuda_ms(
        lambda: rans_decode(buf, total, hk, lk, m, s, lower), 20)
    pre_plain_ms, enc_plain_ms, dec_plain_ms = (
        plain["prepass"], plain["encode"], plain["decode"])
    nw = int(total)
    # bytes the function must move, each input read once and each output
    # written once, at the data's own widths (not the kernels' int64
    # interface buffers): 4 B per bin, mean, scale and lower bound, per
    # decoded value and per 32-bit seed, word and state limb; 1 B per
    # emission flag; only the nw words this message emits; the prepass
    # writes 16 B records (float64 1 / freq, 32-bit c_start and freq)
    pre_bytes = n * (4 + 4 + 4 + 4) + n * 16
    enc_bytes = n * (4 + 4 + 4 + 4) + (4 * S if seeded else 0) \
        + 4 * nw + n * 1 + 2 * 4 * S
    dec_bytes = 4 * nw + 4 + 2 * 4 * S + n * (4 + 4 + 4) + n * 4 + 2 * 4 * S
    # operations: 2 CDF evaluations per coded symbol (the decode's verified
    # bracket needs CDF(v - 1) and CDF(v), as the encode does)
    pre_bound = bound(pre_bytes, 2 * CDF_FLOPS * n)
    enc_bound = bound(enc_bytes, 2 * CDF_FLOPS * n)
    dec_bound = bound(dec_bytes, 2 * CDF_FLOPS * n)
    row = {"S": S, "k": k, "seeded": seeded, "cdf_agreement": cdf_agree,
           "num_words": nw,
           "prepass": {"ms": pre_ms, "plain_ms": pre_plain_ms,
                       "bound_ms": pre_bound[0], "bound_by": pre_bound[1],
                       "depth_bound_ms": depth_ns["decode"] / 1e6,
                       "max_abs_err": pre_err},
           "encode": {"ms": enc_ms, "plain_ms": enc_plain_ms,
                      "bound_ms": enc_bound[0], "bound_by": enc_bound[1],
                      "depth_bound_ms": k * depth_ns["encode"] / 1e6,
                      "max_abs_err": enc_err},
           "decode": {"ms": dec_ms, "event_ms": dec_event_ms,
                      "plain_ms": dec_plain_ms,
                      "bound_ms": dec_bound[0], "bound_by": dec_bound[1],
                      "depth_bound_ms": k * depth_ns["decode"] / 1e6,
                      "max_abs_err": dec_err}}
    emit({"phase": "kernels", **row})
    return row


def grouped_case(C: int = 4, S: int = 768, k: int = 64, seed: int = 110):
    """C seeded containers in one launch of each kernel against C plain
    calls, bit for bit; the grouped launches timed beside one container's."""
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        interleaved as IL,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.cuda_rans import (
        rans_decode,
        rans_encode,
    )

    vc, m, s, lower = clamped_message(S, k, seed, "cuda", C)
    seeds = random_seeds((C, S), seed)
    wk, fk, hk, lk = rans_encode(vc, m, s, lower, seeds)
    buf, total = IL.compact(wk, fk)
    vk, h2, l2 = rans_decode(buf, total, hk, lk, m, s, lower)
    enc_err = dec_err = 0
    for c in range(C):
        wp, fp, hp, lp = IL.encode_plain(vc[c], m[c], s[c], lower[c],
                                         seeds[c])
        enc_err = max(enc_err, max_err([(wk[c], wp), (fk[c], fp),
                                        (hk[c], hp), (lk[c], lp)]))
        vp, h3, l3 = IL.decode_plain(buf[c], total[c], hk[c], lk[c], m[c],
                                     s[c], lower[c])
        dec_err = max(dec_err, max_err([(vk[c], vp), (h2[c], h3),
                                        (l2[c], l3)]))
    assert enc_err == 0 and dec_err == 0, "grouped kernels differ from plain"
    assert torch.equal(vk, vc) and torch.equal(l2, seeds)
    res = {"phase": "grouped", "C": C, "S": S, "k": k,
           "encode_max_abs_err": enc_err, "decode_max_abs_err": dec_err,
           "encode_ms": device_ms(
               lambda: rans_encode(vc, m, s, lower, seeds), 20, ENC),
           "decode_ms": device_ms(
               lambda: rans_decode(buf, total, hk, lk, m, s, lower), 20, DEC),
           "encode_one_ms": device_ms(lambda: rans_encode(
               vc[0], m[0], s[0], lower[0], seeds[0]), 20, ENC),
           "decode_one_ms": device_ms(lambda: rans_decode(
               buf[0], total[0], hk[0], lk[0], m[0], s[0], lower[0]), 20,
               DEC)}
    emit(res)
    return res


def corrupt_case(S: int = 384, k: int = 256, seed: int = 120):
    """The decode kernel on a buffer and states of random words (no valid
    message): it must still equal the plain decode bit for bit."""
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        interleaved as IL,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.cuda_rans import (
        rans_decode,
    )

    _, m, s, lower = clamped_message(S, k, seed, "cuda")
    buf = random_seeds((k * S,), seed)
    hi, lo = random_seeds((S,), seed + 1), random_seeds((S,), seed + 2)
    hi[::7] = 0  # some streams refill at once
    total = torch.tensor(k * S // 2, device="cuda")
    vk, h2, l2 = rans_decode(buf, total, hi, lo, m, s, lower)
    vp, h3, l3 = IL.decode_plain(buf, total, hi, lo, m, s, lower)
    err = max_err([(vk, vp), (h2, h3), (l2, l3)])
    assert err == 0, "decode kernel differs from plain on a corrupt buffer"
    res = {"phase": "corrupt", "S": S, "k": k, "decode_max_abs_err": err}
    emit(res)
    return res


def phase_kernels(depth_ns):
    rows = []
    for i, (S, k) in enumerate(((384, 256), (768, 64))):
        for seeded in (False, True):
            rows.append(kernel_case(S, k, seeded, 100 + 2 * i + seeded,
                                    depth_ns))
    return rows, grouped_case(), corrupt_case()


def path_kernels(rows, paths, depth_ns, seed: int = 130):
    """kernel_case at every (S, k, seeded) a driven path coded with that no
    row holds yet, so each launch shape of every path is held against the
    plain coder."""
    have = {(r["S"], r["k"], r["seeded"]) for r in rows}
    for S, k, seeded in sorted({tuple(s) for p in paths
                                for s in p["kernel_shapes"]} - have):
        rows.append(kernel_case(S, k, seeded, seed, depth_ns))
        seed += 1


# ---------------------------------------------------------------------------
# phase 3b: the DenseLayer kernel
# ---------------------------------------------------------------------------

DENSE_TOL = 1e-4


def dense_launch_shapes(model, x, cond=None):
    """(buf shape, cin, g, slope) of every DenseLayer launch of one no-grad
    forward pass of `model` on x (and cond), in call order, recorded from
    the calls themselves."""
    from finalproject_losslessimagecompression_tpu_torch.models import layers

    seen = []
    real = layers.dense_conv3x3

    def record(buf, cin, w, bias_a, b3, slope):
        seen.append((tuple(buf.shape), cin, w.shape[-1], slope))
        real(buf, cin, w, bias_a, b3, slope)

    layers.dense_conv3x3 = record
    try:
        with torch.no_grad():
            model(x) if cond is None else model(x, cond)
    finally:
        layers.dense_conv3x3 = real
    return seen


def graph_ms(fn, reps: int = 10) -> float:
    """Device ms of one fn() call: `reps` calls captured back to back in
    one CUDA graph, replayed and timed with CUDA events (no host gaps)."""
    from finalproject_losslessimagecompression_tpu_torch.utils.graphs import (
        record_launches,
    )

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), record_launches():
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with record_launches(), torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    _, secs = timed(graph.replay)
    return secs * 1e3 / reps


def dense_case(shape, cin, g, slope, seed: int):
    """One launch shape: the kernel against its plain version, determinism,
    untouched channels and the three timings."""
    from finalproject_losslessimagecompression_tpu_torch.ops import (
        dense_conv as D,
    )
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, h, w, p = shape
    m = n * h * w
    buf = torch.randn(shape, generator=gen, device="cuda")
    buf[..., cin:] = float("nan")
    wk = torch.randn((9, cin, g), generator=gen, device="cuda") / math.sqrt(
        9 * cin)
    bias_a = 0.1 * torch.randn((g, 9), generator=gen, device="cuda")
    b3 = 0.1 * torch.randn((g,), generator=gen, device="cuda")
    ref = buf.clone()
    D.dense_conv3x3_plain(ref, cin, wk, bias_a, b3, slope)
    outs = []
    for _ in range(2):
        out = buf.clone()
        D.dense_conv3x3(out, cin, wk, bias_a, b3, slope)
        outs.append(out)
    torch.cuda.synchronize()
    got, want = outs[0][..., cin:cin + g], ref[..., cin:cin + g]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    same_bits = torch.equal(outs[0].view(torch.int32),
                            outs[1].view(torch.int32))
    untouched = (torch.equal(outs[0][..., :cin], buf[..., :cin])
                 and bool(outs[0][..., cin + g:].isnan().all()))
    ok = err <= DENSE_TOL * max(scale, 1.0) and same_bits and untouched
    geo = dense_geometry(shape, cin, g)
    slots = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    x_nchw = buf[..., :cin].permute(0, 3, 1, 2).contiguous()
    w_oihw = wk.reshape(3, 3, cin, g).permute(3, 2, 0, 1).contiguous()
    flops = 2.0 * m * g * 9 * cin
    nbytes = 4.0 * (m * (cin + g) + 9 * cin * g)
    bound_ms, bound_by = bound(nbytes, flops)
    kernel_ms = graph_ms(
        lambda: D.dense_conv3x3(outs[1], cin, wk, bias_a, b3, slope))
    return {"shape": list(shape), "m": m, "cin": cin, "g": g,
            "slope": slope, "splits": geo.splits, "row_w": geo.row_w,
            "tile_n": geo.tile_n, "blocks": geo.blocks,
            "last_wave_fill": (geo.blocks - 1) % slots / slots + 1 / slots,
            "ok": ok, "max_err": err,
            "scale": scale, "bits_equal": same_bits, "untouched": untouched,
            "kernel_ms": kernel_ms,
            "plain_ms": graph_ms(lambda: D.dense_conv3x3_plain(
                outs[1], cin, wk, bias_a, b3, slope), 3),
            "library_ms": graph_ms(
                lambda: F.conv2d(x_nchw, w_oihw, padding=1)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flops / kernel_ms / 1e9,
            "pct_peak": 100.0 * flops / kernel_ms / 1e-3 / FP32_OPS_PER_S}


def cond_flow():
    """The conditional flow of configs/resflow-cond-imagenet64.yaml at full
    width (seeded weights, projections perturbed)."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCfg,
        IDFlow,
    )

    train = load_config(os.path.join(ROOT, RES_CONFIG))["train"]
    return perturbed(IDFlow(FlowCfg.from_ref(train["flows"]), device="cuda",
                            seed=0))


def twolevel_flow():
    """configs/config_twolevel.yaml's model at full width (seeded weights,
    projections perturbed) and its config."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.models import (
        TwoLevelCfg,
        TwoLevelFlow,
    )

    cfg = TwoLevelCfg.from_ref(load_config(os.path.join(ROOT, TL_CONFIG))[
        "train"]["model"])
    return cfg, perturbed(TwoLevelFlow(cfg, device="cuda", seed=0))


def twolevel_launch_shapes(model, x):
    """`dense_launch_shapes` of the two-level model's rough and fine
    sub-flows on a batch x of 215x178 images."""
    rx, px = model.split_levels(x)
    return dense_launch_shapes(model.rough, rx), dense_launch_shapes(
        model.fine, px)


def dense_geometry(shape, cin, g):
    """`ops.dense_conv.geometry` of a launch shape on this card."""
    from finalproject_losslessimagecompression_tpu_torch.ops import (
        dense_conv as D,
    )

    n, h, w, _ = shape
    return D.geometry(n * h, w, cin, g, torch.cuda.get_device_properties(
        0).multi_processor_count)


def phase_dense(batch: int = 16, queue: int = 4, request: int = 4,
                tl_batch: int = 4):
    from finalproject_losslessimagecompression_tpu_torch.ops import (
        dense_conv as D,
    )
    from finalproject_losslessimagecompression_tpu_torch.train import (
        optim,
        trainer,
    )

    t0 = time.time()
    D.build()
    build_s = time.time() - t0
    cfg, model, codec = flagship_codec()
    xs_np = images(batch, queue, seed=7)
    xs = [torch.from_numpy(x).cuda() for x in xs_np]
    bulk = dense_launch_shapes(model, xs[0])
    assert len(bulk) == 12 * (cfg.nflows + 1) * cfg.nsplit, len(bulk)
    flow = cond_flow()
    x4 = xs[0][:request]
    req = dense_launch_shapes(flow, x4, torch.flip(x4, dims=(1,)))
    del flow
    tl_cfg, tl = twolevel_flow()
    rough, fine = twolevel_launch_shapes(
        tl, torch.from_numpy(twolevel_images(tl_batch, 16)).cuda())
    del tl
    for sub, shapes in ((tl_cfg.rough, rough), (tl_cfg.fine, fine)):
        assert len(shapes) == (sub.couple.nn.depth * sub.nflows
                               + sub.prior_nn.depth) * sub.nsplit, len(shapes)
    cases = []
    for name, shapes in (("imagenet64", bulk), ("resflow-cond", req),
                         ("rough", rough), ("fine", fine)):
        for i, key in enumerate(dict.fromkeys(shapes)):
            row = dense_case(*key, seed=500 + i)
            row["config"] = name
            row["calls"] = shapes.count(key)
            cases.append(row)
            emit({"phase": "dense_case", **row})
    # the narrow geometry at the widths and heights no model launches: W 2
    # and 1, an odd H (segments across image boundaries), g not a multiple
    # of the tile
    for i, key in enumerate((((64, 6, 2, 84), 37, 43, 0.0),
                             ((16, 7, 1, 88), 20, 64, 0.01),
                             ((9, 5, 4, 120), 50, 64, 0.0),
                             ((33, 3, 4, 208), 100, 100, 0.01))):
        row = dense_case(*key, seed=600 + i)
        row["config"] = "narrow"
        row["calls"] = 0
        cases.append(row)
        emit({"phase": "dense_case", **row})
    narrow = [dense_geometry(*s[:3]).row_w > 0 for s in bulk + req + rough]
    reduces = sum(dense_geometry(*s[:3]).splits > 1 for s in bulk)
    # the fused codec: eager, captured, then one replayed pass counted
    warm(codec, xs)
    before = (D.dense_conv3x3.launches, D.splitk_reduce.launches,
              D.dense_conv3x3.narrow_launches)
    packed = codec.compress_many(xs)
    recs = codec.decompress_many(packed, fetch=True)
    exact = all(np.array_equal(r, x) for r, x in zip(recs, xs_np))
    launched = (D.dense_conv3x3.launches - before[0],
                D.splitk_reduce.launches - before[1],
                D.dense_conv3x3.narrow_launches - before[2])
    want = (len(bulk) * queue * 2, reduces * queue * 2, 0)
    # one captured train call (a warm-up, a capture, a replay): none
    with open(os.path.join(ROOT, "lic_bench", "configs",
                           "imagenet64.json")) as f:
        c = json.load(f)
    model.train()
    opt = optim.build_optimizer(model.parameters(), c["optimizer"],
                                c["scheduler"], c["step_per_epoch"])
    multi = trainer.make_multi_train_step(model, opt, 1)
    before_train = D.dense_conv3x3.launches + D.splitk_reduce.launches
    for _ in range(3):
        multi(xs[0][None]).cpu()
    train_launches = (D.dense_conv3x3.launches + D.splitk_reduce.launches
                      - before_train)
    ok = (all(r["ok"] for r in cases) and exact and launched == want
          and train_launches == 0 and not any(narrow)
          and all(dense_geometry(*s[:3]).row_w == 4 for s in fine))

    def per_call(config, key, scale=1):
        return sum(r[key] * r["calls"] for r in cases
                   if r["config"] == config) * scale

    out = {"phase": "dense", "ok": ok, "build_s": build_s,
           "shapes": len(cases), "max_err_rel": max(
               r["max_err"] / max(r["scale"], 1.0) for r in cases),
           "round_trip_exact": exact, "launches": launched,
           "launches_want": want, "train_launches": train_launches,
           "bulk_kernel_ms_pass": sum(r["kernel_ms"] * r["calls"] for r in
                                      cases if r["config"] == "imagenet64")
           * queue * 2,
           "bulk_library_ms_pass": sum(r["library_ms"] * r["calls"] for r in
                                       cases if r["config"] == "imagenet64")
           * queue * 2,
           "request_kernel_ms": sum(r["kernel_ms"] * r["calls"] for r in
                                    cases if r["config"] == "resflow-cond")
           * 2,
           # one batch of tl_batch images, one direction
           "twolevel_ms_batch": {
               sub: {key: per_call(sub, key) for key in
                     ("kernel_ms", "bound_ms", "plain_ms", "library_ms")}
               for sub in ("fine", "rough")},
           "fine_under_library_and_plain": all(
               r["kernel_ms"] < min(r["library_ms"], r["plain_ms"])
               for r in cases if r["config"] == "fine")}
    emit(out)
    assert ok, out
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


def flagship_codec(granularity=None):
    from finalproject_losslessimagecompression_tpu_torch.models import (
        CouplingCfg,
        DenseBlockCfg,
        FlowCfg,
        FlowCodec,
        IDFlow,
    )

    cfg = FlowCfg(
        H=64, W=64, C=3, nflows=8, nsplit=3,
        couple=CouplingCfg(0.75, DenseBlockCfg(512, 12, "ReLU", "float32")),
        prior_nn=DenseBlockCfg(512, 12, "ReLU", "float32"),
    )
    model = perturbed(IDFlow(cfg, device="cuda", seed=0))
    return cfg, model, FlowCodec(model, num_streams=8192,
                                 granularity=granularity)


def images(batch: int, queue: int, seed: int = 1):
    """Synthetic images on the 1/256 grid, uniform noise (as bench.py)."""
    rng = np.random.default_rng(seed)
    return [
        (np.round(rng.uniform(0, 1, (batch, 64, 64, 3)) * 256).astype(
            np.float32) / 256.0)
        for _ in range(queue)
    ]


def timed(fn):
    """(fn(), seconds), fenced with synchronize on both sides and timed
    with CUDA events."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b) / 1e3


def phase_e2e(batch: int = 16, queue: int = 4):
    from finalproject_losslessimagecompression_tpu_torch.models.exact import (
        finish,
        pack_queue,
    )
    from finalproject_losslessimagecompression_tpu_torch.models.idflow import (
        log_likelihood,
    )

    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCodec,
    )

    cfg, model, codec = flagship_codec()
    assert codec.granularity == "fused", codec.granularity
    xs_np = images(batch, queue)
    xs = [torch.from_numpy(x).cuda() for x in xs_np]
    warm(codec, xs)  # an eager pass, then the capture of the two graphs
    level = FlowCodec(model, num_streams=8192, granularity="level")
    level.decompress_many(level.compress_many(xs), fetch=True)
    torch.cuda.synchronize()
    t0 = time.time()
    level.decompress_many(level.compress_many(xs), fetch=True)
    level_wall = time.time() - t0

    wrappers = kernel_wrappers()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    t0 = time.time()
    packed = codec.compress_many(xs)
    recs = codec.decompress_many(packed, fetch=True)
    wall = time.time() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    # level-major queue passes: one launch of each kernel per level
    assert all(v == cfg.nsplit for v in launches.values()), launches
    exact = all(np.array_equal(r, x) for r, x in zip(recs, xs_np))
    assert exact, "main path round trip is not bit-exact"
    real_bpd = float(np.mean([codec.real_bpd(b, i) for b, i in packed]))
    with torch.no_grad():
        lat, means, logscales = model(xs[0])
        lp, _ = log_likelihood(cfg, lat, means, logscales)
        analytic_bpd = float(-lp.mean()) / math.log(2.0)
    assert all(bool(torch.isfinite(t).all()) for t in lat + means + logscales)
    assert [tuple(t.shape[1:]) for t in lat] == [
        tuple(s) for s in model.latent_shapes]

    # phase split of one more queue pass, each fenced with synchronize and
    # timed with CUDA events
    per_batch, t_enc = timed(lambda: codec.encode_queue(xs))
    packed2, t_pack = timed(lambda: pack_queue(per_batch))
    (xs2, oks), t_dec = timed(lambda: codec.decode_queue(packed2))
    _, t_verify = timed(lambda: finish(xs2, oks))
    res = {"phase": "e2e", "batch": batch, "queue": queue,
           "bit_exact": exact, "real_bpd": real_bpd,
           "analytic_bpd": analytic_bpd,
           "granularity": codec.granularity,
           "images_per_s": batch * queue / wall, "wall_s": wall,
           "level_images_per_s": batch * queue / level_wall,
           "level_wall_s": level_wall,
           "capture_s": codec.capture_seconds,
           "phases_s": {"encode": t_enc, "pack": t_pack, "decode": t_dec,
                        "verify": t_verify},
           "launches": launches,
           "streams_per_level": [codec._level_S(lv, batch)
                                 for lv in range(cfg.nsplit)],
           "kernel_shapes": coded_shapes(codec, [batch])}
    emit(res)
    # the replayed pass's launches, as the profiler records them on the
    # device, against the wrappers' counts (a replay's capture tally)
    res["profile"] = profile_pass(
        lambda: codec.decompress_many(codec.compress_many(xs), fetch=True),
        want=launches)
    return res


def profile_pass(run, phase: str = "profile", top: int = 12, want=None):
    """torch.profiler over one queue pass `run()` (`profile_busy`): device
    time by kernel name, of the convolutions and of the rANS kernels, and
    the share of the profiled pass's wall the device sat idle.  `want`
    ({kernel: launches}): the rANS launches the profiler must record in
    the pass (measured on the device, replayed graphs included), traced
    again up to three times where the profiler dropped records.  Emits and
    returns the record."""
    busy = profile_busy(run, want=want, label=phase)
    kernels = busy.pop("kernels")
    rans_us = sum(us for name, us, _ in kernels
                  if any(n in name for n in ENC + DEC))
    res = {"phase": phase, "wall_s": busy["wall_s"],
           "device_busy_s": busy["device_busy_s"],
           "rans_device_ms": rans_us / 1e3, "rans_calls": busy["rans_calls"],
           "traces": busy["traces"],
           "conv_device_ms": conv_ms(kernels),
           "device_idle_share": busy["device_idle_share"],
           "top": [{"name": name[:80], "device_ms": us / 1e3, "calls": n}
                   for name, us, n in kernels[:top]]}
    emit(res)
    return res


def each(n: int):
    """{rANS kernel: n}: n launches of each."""
    return {k: n for k in ENC + DEC}


def warm(codec, xs):
    """Two queue passes: the first runs eagerly (and builds cuDNN plans,
    handles and the kernels' library), the second captures a fused codec's
    two graphs, so the next pass replays them."""
    for _ in range(2):
        codec.decompress_many(codec.compress_many(xs), fetch=True)
    torch.cuda.synchronize()


def conv_ms(kernels) -> float:
    """Device ms of the convolution kernels in kernel_times' list (cuDNN's
    and the implicit-GEMM / Winograd / FFT kernels it runs)."""
    keys = ("conv", "cudnn", "xmma", "implicit", "winograd", "fft")
    return sum(us for name, us, _ in kernels
               if any(k in name.lower() for k in keys)) / 1e3


# ---------------------------------------------------------------------------
# phase 4b: the fused granularity (CUDA graphs) against the level path
# ---------------------------------------------------------------------------


def graph_pool_bytes(codec) -> int:
    """Bytes of the memory segments of a FlowCodec's graph pool."""
    from finalproject_losslessimagecompression_tpu_torch.utils.graphs import (
        pool_bytes,
    )

    return pool_bytes(codec.graph_pool)


def graph_stats(codecs):
    """Capture seconds, graphs and graph pool bytes of FlowCodecs."""
    return {"capture_s": sum(c.capture_seconds for c in codecs),
            "captures": sum(c.captures for c in codecs),
            "graphs": sum(len(c.graph_cache.entries) for c in codecs),
            "graph_pool_bytes": sum(graph_pool_bytes(c) for c in codecs)}


def round_trip(codec, xs):
    """One queue pass: compress_many, then decompress_many(fetch=True)."""
    return codec.decompress_many(codec.compress_many(xs), fetch=True)


def modes_agree(wrappers, fused, level, xs, xs_np, n_launch):
    """Hold a fused codec (FlowCodec, ResidualCodec or TwoLevelCodec)
    against its level twin on one queue: the first fused call of the
    queue runs eagerly and the second captures its graphs (each with
    `n_launch` launches of each kernel each way: the capture's warm-up
    counts none), containers byte-identical, each mode decodes the
    other's exactly, then timed passes of each (fused launches counted)."""

    def run(codec, packed=None):
        return (codec.compress_many(xs) if packed is None
                else codec.decompress_many(packed, fetch=True))

    exact = lambda got: all(  # noqa: E731
        np.array_equal(r, x) for r, x in zip(got, xs_np))
    calls = {}
    for call in ("first_call", "capture_call"):
        reset_launches(wrappers)
        packed_f, t_c = timed(lambda: run(fused))
        recs, t_d = timed(lambda: run(fused, packed_f))
        launches = launch_counts(wrappers)
        assert all(v == n_launch for v in launches.values()), launches
        assert exact(recs), f"fused round trip ({call}) is not bit-exact"
        calls[call] = {"launches": launches,
                       "s": {"compress": t_c, "decompress": t_d},
                       "packed": packed_f}
    assert calls["first_call"].pop("packed") == calls["capture_call"].pop(
        "packed"), "eager and captured fused containers differ"
    packed_l = run(level)
    assert packed_f == packed_l, "fused and level containers differ"
    assert exact(run(level, packed_f)), "level decode of fused containers"
    assert exact(run(fused, packed_l)), "fused decode of level containers"
    walls = {}
    for name, codec in (("fused", fused), ("level", level), ("fused", fused)):
        reset_launches(wrappers)
        t0 = time.time()
        assert exact(run(codec, run(codec))), name
        walls.setdefault(name, []).append(time.time() - t0)
        if name == "fused":
            launches = launch_counts(wrappers)
            assert all(v == n_launch for v in launches.values()), launches
    images = sum(x.shape[0] for x in xs_np)
    return {"byte_identical": True, "cross_decode_exact": True,
            "launches_first_call": calls["first_call"]["launches"],
            "launches_capture_call": calls["capture_call"]["launches"],
            "launches": launches,
            "first_call_s": calls["first_call"]["s"],
            "capture_call_s": calls["capture_call"]["s"],
            "wall_s": walls,
            "images_per_s": {k: images / min(v) for k, v in walls.items()}}


def idle_shares(fused, xs, n_launch, prefix=""):
    """The fused mode's device idle share over a profiled queue pass
    (`<prefix>fused_profile`) that must record `n_launch` launches of each
    rANS kernel; returns {"fused": profile}.  (The level mode's launches
    are counted by its wrappers; its traced eager pass cost more time than
    the number says.)"""
    return {"fused": profile_pass(lambda: round_trip(fused, xs),
                                  phase=f"{prefix}fused_profile", top=6,
                                  want=each(n_launch))}


def escape_matrix(wrappers, model, fused, nsplit):
    """An outlier queue through the flagship, decoded twice by each codec:
    with MAX_OUTLIERS 4 the level path decodes it both times (counted),
    with the default the first call runs the fused program eagerly and
    the second captures it, so the graph patches the escapes."""
    from finalproject_losslessimagecompression_tpu_torch.codec.container import (  # noqa: E501
        unpack_streams,
    )
    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCodec,
    )

    x = images(2, 1, seed=7)[0]
    x[:, ::11, ::11, 0] += 40.0  # far outside mean +- 4
    packed = fused.compress_many([torch.from_numpy(x).cuda()])
    counts = [unpack_streams(b).oow_count for b in packed[0][0]]
    assert 4 < max(counts) <= fused.MAX_OUTLIERS, counts
    four = FlowCodec(model, num_streams=8192)
    four.MAX_OUTLIERS = 4
    out = {"oow_counts": counts}
    for name, codec in (("max_outliers_4", four), ("max_outliers_256",
                                                   fused)):
        before = (codec.level_fallbacks, codec.captures)
        for _ in range(2):
            reset_launches(wrappers)
            rec = codec.decompress_many(packed, fetch=True)[0]
            assert np.array_equal(rec, x), f"{name}: escapes not bit-exact"
            launches = launch_counts(wrappers)
            assert launches == {n: nsplit if n in DEC else 0
                                for n in launches}, launches
        out[name] = {"level_fallbacks": codec.level_fallbacks - before[0],
                     "captures": codec.captures - before[1],
                     "launches": launches, "bit_exact": True}
    assert out["max_outliers_4"]["level_fallbacks"] == 2
    assert out["max_outliers_4"]["captures"] == 0
    assert out["max_outliers_256"]["level_fallbacks"] == 0
    assert out["max_outliers_256"]["captures"] == 1
    return out


def fused_residual(wrappers, batch: int = 16, queue: int = 4):
    """ResidualCodec (configs/resflow-cond-imagenet64.yaml at full width)
    with a fused flow codec against one with a level flow codec."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCfg,
        FlowCodec,
        IDFlow,
        ResidualCodec,
        build_vqvae_from_ref,
    )

    train = load_config(os.path.join(ROOT, RES_CONFIG))["train"]
    cfg = FlowCfg.from_ref(train["flows"])
    flow = perturbed(IDFlow(cfg, device="cuda", seed=0))
    vqvae = build_vqvae_from_ref(train["vqvae"], device="cuda", seed=2).eval()
    size = tuple(train["input_size"])
    fused = ResidualCodec(vqvae, FlowCodec(flow, num_streams=4096), size)
    level = ResidualCodec(vqvae, FlowCodec(flow, num_streams=4096,
                                           granularity="level"), size)
    xs_np = images(batch, queue, seed=5)
    xs = [torch.from_numpy(x).cuda() for x in xs_np]
    round_trip(level, xs)  # cuDNN plans of the VQ-VAE and the flows
    out = modes_agree(wrappers, fused, level, xs, xs_np, cfg.nsplit)
    profiles = idle_shares(fused, xs, cfg.nsplit, "residual_")
    out["idle_share"] = {k: p["device_idle_share"]
                         for k, p in profiles.items()}
    out["profiled_launches"] = {k: p["rans_calls"]
                                for k, p in profiles.items()}
    return {**out, **graph_stats([fused.codec])}


def fused_twolevel(wrappers, batch: int = 4, queue: int = 2):
    """TwoLevelCodec(granularity="fused") against "level" on
    configs/config_twolevel.yaml's model at full width."""
    from finalproject_losslessimagecompression_tpu_torch.models import (
        TwoLevelCodec,
    )

    cfg, model = twolevel_flow()
    fused = TwoLevelCodec(model, num_streams=4096, granularity="fused")
    level = TwoLevelCodec(model, num_streams=4096, granularity="level")
    imgs = twolevel_images(batch * queue, 16)
    xs_np = [imgs[i * batch:(i + 1) * batch] for i in range(queue)]
    xs = [torch.from_numpy(x).cuda() for x in xs_np]
    round_trip(level, xs)
    out = modes_agree(wrappers, fused, level, xs, xs_np,
                      cfg.rough.nsplit + cfg.fine.nsplit)
    return {**out, **graph_stats([fused.rough_codec, fused.fine_codec])}


def phase_fused(wrappers, batch: int = 16, queue: int = 4):
    """Phase 4b: the fused granularity against the level path."""
    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCodec,
    )

    t0 = time.time()
    cfg, model, fused = flagship_codec("fused")
    level = FlowCodec(model, num_streams=8192, granularity="level")
    xs_np = images(batch, queue, seed=2)
    xs = [torch.from_numpy(x).cuda() for x in xs_np]
    round_trip(level, xs)  # cuDNN plans, so capture_s is the graphs' own
    flagship = modes_agree(wrappers, fused, level, xs, xs_np, cfg.nsplit)
    flagship.update(graph_stats([fused]))
    # the aliasing check: two decompress_many(fetch=False) results, the
    # second replay after the first result was returned
    xs2_np = images(batch, queue, seed=3)
    packed1 = fused.compress_many(xs)
    packed2 = fused.compress_many([torch.from_numpy(x).cuda()
                                   for x in xs2_np])
    got1 = fused.decompress_many(packed1)
    got2 = fused.decompress_many(packed2)
    for got, want in ((got1, xs_np), (got2, xs2_np)):
        assert all(np.array_equal(g.cpu().numpy(), x)
                   for g, x in zip(got, want)), "a replay overwrote a result"
    flagship["aliasing_check"] = True
    profiles = idle_shares(fused, xs, cfg.nsplit)
    idle = {k: p["device_idle_share"]
            for k, p in profiles.items()}
    flagship["profiled_launches"] = {k: p["rans_calls"]
                                     for k, p in profiles.items()}
    escapes = escape_matrix(wrappers, model, fused, cfg.nsplit)
    del fused, level, model
    res = {"phase": "fused", "batch": batch, "queue": queue,
           "flagship": flagship, "idle_share": idle, "escapes": escapes,
           "residual": fused_residual(wrappers, queue=queue),
           "twolevel": fused_twolevel(wrappers)}
    res["phase_s"] = time.time() - t0
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 5: the training path at full width
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_CONFIG = "configs/imagenet64.yaml"
# the run's checkpoints and logs, removed at the end
TRAIN_DIR = os.path.join(ROOT, "logs", "chip_smoke_train")


def natural_loader(size, batch, length, seed, train):
    """A cached NaturalSynthetic loader config of [H, W, 3] images (the
    repository holds no ImageNet64 or CelebA)."""
    return {"name": "CustomDataLoader", "batch_size": batch, "nbits": 8,
            "train": train, "shuffle": train, "cache": True,
            "dataset": {"name": "NaturalSynthetic", "size": [*size, 3],
                        "length": length, "seed": seed}}


def train_config():
    """configs/imagenet64.yaml (read by the port's reader) with the two
    dataloaders on NaturalSynthetic and the run cut to 8 steps."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        apply_overrides,
        load_config,
    )

    config = load_config(os.path.join(ROOT, TRAIN_CONFIG))
    config["train"]["train_dataloader"] = natural_loader((64, 64), 16, 128, 1,
                                                         True)
    config["train"]["test_dataloader"] = natural_loader((64, 64), 16, 16, 0,
                                                        False)
    return apply_overrides(config, [
        "train.max_step=8", "train.evaluate_interval=8",
        "train.save_interval=8", "train.max_eval_batches=1",
        "train.log_every=4",
        f"train.save_path={TRAIN_DIR}/imagenet64.ckpt",
        f"train.writer_path={TRAIN_DIR}/log",
    ])


def logged(tag, log_dir=os.path.join(TRAIN_DIR, "log"),
           name="metrics.jsonl"):
    with open(os.path.join(log_dir, name)) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in recs if r["tag"] == tag]


def same_state(a, b) -> bool:
    """Equal params, optimizer state and step of two trainers."""
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    return (a.step == b.step and sa["count"] == sb["count"]
            and all(torch.equal(x, y) for x, y in zip(
                a.model.state_dict().values(), b.model.state_dict().values()))
            and sa["state"].keys() == sb["state"].keys()
            and all(sa["state"][i][k].device == sb["state"][i][k].device
                    and torch.equal(sa["state"][i][k], sb["state"][i][k])
                    for i in sa["state"] for k in sa["state"][i]))


def fill_caches(t):
    """Data generation is set-up: fill a trainer's loader caches before the
    timed steps."""
    for ds in (t.trainloader.dataset, t.testloader.dataset):
        for i in range(len(ds)):
            ds[i]  # noqa: B018 (fills the cache)


def phase_train(wrappers, blocks: int = 3):
    """Phase 5: the flow trainer's loop at full width, captured by default
    (the first K-step block eager, the second captured, then replays), with
    the learning rate changing between blocks 2 and 3; eval with coding at
    the epoch boundary, checkpoint and resume; then the captured trainer
    against an eager twin (`against_eager`)."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        apply_overrides,
        build_trainer,
    )
    from finalproject_losslessimagecompression_tpu_torch.train.trainer import (
        LN2,
    )
    from finalproject_losslessimagecompression_tpu_torch.utils.profiling import (
        device_peak_tflops,
    )

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    config = train_config()
    K = config["train"]["steps_per_dispatch"]
    steps = blocks * K
    # an epoch of two blocks: the learning rate changes between the
    # capturing block and the next replay; eval (with coding) runs once,
    # at the epoch boundary
    apply_overrides(config, [
        f"train.max_step={steps}", f"train.evaluate_interval={2 * K}",
        f"train.save_interval={steps}", f"train.step_per_epoch={2 * K}"])
    t = build_trainer(config)
    cfg, batch = t.cfg, t.trainloader.batch_size
    assert t.graphs and t.train_multi is not None
    fill_caches(t)
    fixed = t._to_device(next(iter(t.testloader)))
    bpd_before = float(t.eval_step(fixed)[0]) / LN2
    lrs = record_lrs(t.optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t.train()  # `blocks` blocks of K steps, eval (with coding), save
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    peak_mem_gb = torch.cuda.max_memory_allocated() / 1e9
    bpd_after = float(t.eval_step(fixed)[0]) / LN2

    losses = [v for _, v in logged("train loss")]
    assert len(losses) == t.max_step and all(map(math.isfinite, losses)), \
        losses
    assert bpd_after < bpd_before, (bpd_before, bpd_after)
    errors = [v for _, v in logged("coding errors")]
    ev = {tag: logged(tag)[-1][1] for tag in ("test bpd", "real bpd")}
    assert errors and all(e == 0 for e in errors), errors
    # training launches no rANS kernel; each eval codes one batch, one
    # launch of each kernel per level
    assert all(v == cfg.nsplit * len(errors) for v in launches.values()), \
        launches
    step = t.train_multi
    assert (step.captures, step.replays) == (1, blocks - 1), \
        (step.captures, step.replays)
    flops = logged("flops per step")[0][1]
    peak, peak_name = device_peak_tflops("cuda", cfg.couple.nn.dtype)
    resumed = build_trainer(apply_overrides(
        copy.deepcopy(config), [f"train.model.load_path={t.save_path}"]))
    resume_equal = same_state(t, resumed)
    assert resume_equal, "a resumed trainer differs from the saved one"
    del resumed
    rep = against_eager(
        "train", t, step, lambda: build_trainer(config), blocks,
        lambda tw: tw.train_multi.eager(tw.next_block(K)),
        lambda: t.train_block(t.next_block(K)), lrs, K, batch * K, flops)
    res = {"phase": "train", "config": TRAIN_CONFIG, "batch": batch, "K": K,
           "steps": t.step, "step_s": rep["step_s"],
           "train_images_per_s": batch / rep["step_s"],
           "flops_per_step": flops, "mfu_peak_tflops": peak,
           "mfu_peak": peak_name, "peak_mem_gb": peak_mem_gb,
           "losses": losses, "bpd_before": bpd_before,
           "bpd_after": bpd_after, "test_bpd": ev["test bpd"],
           "real_bpd": ev["real bpd"], "coding_errors": int(sum(errors)),
           "eval_batches": len(errors),
           "launches_eval": {k: v // len(errors)
                             for k, v in launches.items()},
           "resume_equal": resume_equal, **rep}
    emit(res)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# captured train steps against their eager bodies
# ---------------------------------------------------------------------------


def record_lrs(opt):
    """Record, at every call of a step of `opt` (a train.optim.Optimizer),
    the learning rates the step is about to read from its static tensor
    (read back after the copy that writes them)."""
    seen = []
    real = opt.next_lrs

    def next_lrs(K):
        lrs = real(K)
        seen.append((opt.count, lrs.tolist()))
        return lrs

    opt.next_lrs = next_lrs
    return seen


def train_state(t):
    """Every piece of a trainer's training state by name: the model's
    parameters and buffers (BatchNorm running averages, the codebook), the
    optimizer's moments and step counters and its update count, and where
    the trainer has them the VQ usage counts, the replaced-codeword count,
    the tuner and the patch draw's generator state."""
    opt = getattr(t, "tuner_opt", None) or t.optimizer
    sd = opt.state_dict()
    out = {f"model.{k}": v for k, v in t.model.state_dict().items()}
    out["opt.count"] = torch.tensor(sd["count"])
    out.update({f"opt.{i}.{k}": v for i, st in sd["state"].items()
                for k, v in st.items()})
    for name in ("counts", "replaced", "tuner"):
        if hasattr(t, name):
            out[name] = getattr(t, name).detach()
    if hasattr(t, "gen"):
        out["gen"] = t.gen.get_state()
    return out


def state_diff(a, b):
    """(the entries of two train_states that are not torch.equal, the
    largest absolute difference over them; 0.0 where every entry is)."""
    names, worst = [], 0.0
    for k, x in a.items():
        y = b[k]
        if x.device == y.device and torch.equal(x, y):
            continue
        names.append(k)
        worst = max(worst, float((x.double().cpu() - y.double().cpu())
                                 .abs().max()))
    return names, worst


def call_seconds(run, reps: int) -> float:
    """Host seconds per call of run(), over `reps` calls fenced with
    synchronize on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def profile_step(run, label: str, top: int = 8):
    """torch.profiler over one call of run() (`profile_busy`): device busy
    seconds and idle share of its wall, kernel launches, the top kernels
    (kernels only, user annotations excluded)."""
    busy = profile_busy(run, label=label)
    kernels = busy["kernels"]
    return {"profile": label, "wall_s": busy["wall_s"],
            "device_busy_s": busy["device_busy_s"],
            "device_idle_share": busy["device_idle_share"],
            "kernel_launches": sum(n for _, _, n in kernels),
            "top": [{"name": name[:80], "device_ms": us / 1e3, "calls": n}
                    for name, us, n in kernels[:top]]}


def against_eager(label, t, step, build, calls, drive_eager,
                  drive_captured, lrs, updates, images, flops):
    """A trainer `t` that ran `calls` calls of its captured step `step`
    (the first eager, the second capturing, then replays) held against a
    twin `build()` makes from its config (the same seed, weights and
    loader) running the same calls through the step's eager body
    (`drive_eager(twin)`): every state entry equal bit for bit (two eager
    twins of every trainer here have measured equal on the H100, so one
    twin is held to equality).  `lrs` (from
    record_lrs) must differ across the replays and equal the schedule at
    the update counts.  Then a replay (`drive_captured()`) against an
    eager call, timed, the replay profiled once: step_s (a call over
    its `updates` updates), images/s (`images` per call), MFU from `flops`
    per update (or `flops(twin)`, counted on the twin after the
    comparison), idle share; captures, capture seconds, graph pool
    bytes."""
    from finalproject_losslessimagecompression_tpu_torch.utils.profiling import (  # noqa: E501
        device_peak_tflops,
    )

    peak, _ = device_peak_tflops("cuda", "float32")
    twins = [build()]
    fill_caches(twins[0])
    for _ in range(calls):
        drive_eager(twins[0])
    torch.cuda.synchronize()
    names, diff = state_diff(train_state(t), train_state(twins[0]))
    assert not names, (label, names[:8], diff)
    if callable(flops):
        flops = flops(twins[0])
    replayed = lrs[1:calls]  # the capturing call replays too
    opt = getattr(t, "tuner_opt", None) or t.optimizer
    assert len({tuple(v) for _, v in replayed}) > 1, (label, lrs)
    assert all(v == [float(np.float32(opt.schedule(c + j)))
                     for j in range(updates)] for c, v in lrs), (label, lrs)
    graph_s = call_seconds(drive_captured, 1)
    eager_s = call_seconds(lambda: drive_eager(twins[0]), 1)
    out = {"flops_per_step": flops,
           "captures": step.captures, "capture_s": step.capture_seconds,
           "graph_pool_bytes": step.pool_bytes,
           "equal_to_eager": not names, "max_abs_diff_to_eager": diff,
           "lrs_replayed": [v for _, v in replayed]}
    for mode, call_s, run in (("captured", graph_s, drive_captured),
                              ("eager", eager_s, None)):
        # the replay profiled; an eager call traced (tens of thousands of
        # launches) cost more host time than its idle share told
        prof = {} if run is None else profile_step(run, f"{label}_{mode}")
        step_s = call_s / updates
        out[mode] = {"step_s": step_s, "images_per_s": images / call_s,
                     "achieved_tflops": flops / step_s / 1e12 if flops
                     else None,
                     "mfu_pct": 100.0 * flops / step_s / 1e12 / peak
                     if flops and peak else None, **prof}
    out["step_s"] = out["captured"]["step_s"]
    del twins
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 6-7: the file codec CLI and the residual pipeline at full width
# ---------------------------------------------------------------------------

RES_CONFIG = "configs/resflow-cond-imagenet64.yaml"
# the phases' checkpoints and files, removed at the end
CLI_DIR = os.path.join(ROOT, "logs", "chip_smoke_cli")
# the file CLI in a process of its own (`python -c CLI_CHILD <CLI args>`):
# it runs `cli.codec.main`, then prints the kernels' launch counts as JSON
CLI_CHILD = """
import json, sys
from finalproject_losslessimagecompression_tpu_torch.cli import codec
from finalproject_losslessimagecompression_tpu_torch.codec import cuda_rans
codec.main(sys.argv[1:])
print(json.dumps({f.__name__ + "_kernel": f.launches for f in (
    cuda_rans.rans_cdf_prepass, cuda_rans.rans_encode, cuda_rans.rans_decode)}))
"""


def write_images(d: str, shapes, seed: int):
    """[(path, uint8 array)] of uniform-noise .npy images."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        arr = rng.integers(0, 256, shape).astype(np.uint8)
        path = os.path.join(d, f"img{i:02d}_{shape[0]}x{shape[1]}.npy")
        np.save(path, arr)
        out.append((path, arr))
    return out


def lic_stats(paths):
    """{mode: {"files", "bytes", "bpd"}} of .lic files, from their headers."""
    import struct

    out = {}
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        (hlen,) = struct.unpack("<I", data[4:8])
        h = json.loads(data[8:8 + hlen])
        m = out.setdefault(h["mode"], {"files": 0, "bytes": 0, "dims": 0})
        m["files"] += 1
        m["bytes"] += len(data)
        m["dims"] += math.prod(h["orig"])
    for m in out.values():
        m["bpd"] = 8.0 * m["bytes"] / m.pop("dims")
    return out


def check_decoded(outdir, srcs):
    for path, arr in srcs:
        name = os.path.splitext(os.path.basename(path))[0] + ".npy"
        got = np.load(os.path.join(outdir, name))
        assert np.array_equal(got, arr), f"{name} is not bit-exact"


def save_params(model, path):
    from finalproject_losslessimagecompression_tpu_torch.train.checkpoint import (  # noqa: E501
        save_checkpoint,
    )

    save_checkpoint(path, {"params": model.state_dict()})
    return path


def phase_cli(wrappers):
    """The serve session of the file codec CLI at full width."""
    from finalproject_losslessimagecompression_tpu_torch.cli import codec as C
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCfg,
        FlowCodec,
        IDFlow,
    )

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    config = os.path.join(ROOT, TRAIN_CONFIG)
    cfg = FlowCfg.from_ref(load_config(config)["train"]["model"])
    ckpt = save_params(perturbed(IDFlow(cfg, device="cuda", seed=0)),
                       os.path.join(CLI_DIR, "imagenet64.ckpt"))
    indir, outdir = os.path.join(CLI_DIR, "in"), os.path.join(CLI_DIR, "out")
    flow_srcs = write_images(indir, [(64, 64, 3)] * 5 + [(150, 200, 3)], 3)
    escape_srcs = write_images(os.path.join(CLI_DIR, "in2"),
                               [(5, 6, 3), (64, 64, 3)], 4)
    # 150x200 pads to 192x256: 3 x 4 tiles of 64x64; every other file
    # (the 5x6 one padded) is one tile
    tile_counts = [1] * 5 + [3 * 4]
    tiles = sum(tile_counts)
    # the chunk batch sizes (1, 8 and 4): one stream layout each per level
    batches = sorted({b for n in tile_counts for b in C._chunk_sizes(n)})
    C.TIMER.totals.clear()
    C.TIMER.counts.clear()
    t0 = time.time()
    pipe = C._load_model(config, ckpt, 4096)
    torch.cuda.synchronize()
    startup_s = time.time() - t0

    def command(verb, srcs, stored_fallback, pipe=pipe):
        paths = [p for p, _ in srcs] if verb == "compress" else [
            os.path.join(outdir, os.path.splitext(os.path.basename(p))[0]
                         + ".lic") for p, _ in srcs]
        for w in wrappers.values():
            w.launches = 0
        answer = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()):  # per-file lines
            C.serve(pipe, lines=[f"{verb} {outdir} " + " ".join(paths)],
                    out=answer, stored_fallback=stored_fallback, ext=".npy")
        reply = answer.getvalue().split()
        assert reply[0] == "ok", reply
        return {"command": verb, "files": len(srcs), "ok_s": float(reply[1]),
                "launches": {n: w.launches for n, w in wrappers.items()}}

    # three commands each way: the first of a chunk layout runs eagerly,
    # the second captures its graph, the third replays it
    cmds = ([command("compress", flow_srcs, False) for _ in range(3)]
            + [command("decompress", flow_srcs, False) for _ in range(3)])
    check_decoded(outdir, flow_srcs)

    def expect(c, layouts):
        """one launch of each coding kernel per stream layout per level,
        in the command's direction only"""
        assert c["launches"] == {
            n: layouts * cfg.nsplit if (n in DEC) == (
                c["command"] == "decompress") else 0
            for n in c["launches"]}, c

    for c in cmds:
        expect(c, len(batches))
    flow_lics = [os.path.join(outdir, os.path.splitext(os.path.basename(p))[0]
                              + ".lic") for p, _ in flow_srcs]
    flow_stats = lic_stats(flow_lics)
    assert list(flow_stats) == ["flow"], flow_stats
    # (the escape session below rewrites img01_64x64.lic with its own)
    written = [open(p, "rb").read() for p in flow_lics]
    # the escape on: both files are flow-coded (one-tile chunks), then the
    # smaller container is written.  The decompress mixes those containers
    # with one flow container of the first session, so the stored and the
    # flow entries of one command are told apart and grouped per file.
    mixed = escape_srcs + flow_srcs[:1]
    cmds += [command("compress", escape_srcs, True),
             command("decompress", mixed, True)]
    for c in cmds[6:]:
        expect(c, 1)
    check_decoded(outdir, mixed)
    esc_lics = [os.path.join(outdir, os.path.splitext(os.path.basename(p))[0]
                             + ".lic") for p, _ in escape_srcs]
    assert lic_stats(esc_lics[:1]).keys() <= {"stored-zlib", "stored-png"}
    mixed_stats = lic_stats(esc_lics + flow_lics[:1])
    assert "flow" in mixed_stats and len(mixed_stats) > 1, mixed_stats
    # the warm session again with the codec at granularity "level": the
    # same files byte for byte; then each mode's two commands profiled
    level_pipe = C._PlainPipeline(
        FlowCodec(pipe.codec.model, num_streams=4096, granularity="level"),
        pipe.fingerprint)
    level_cmds = [command("compress", flow_srcs, False, level_pipe),
                  command("decompress", flow_srcs, False, level_pipe)]
    for c in level_cmds:
        expect(c, len(batches))
    assert [open(p, "rb").read() for p in flow_lics] == written, \
        "level and fused .lic files differ"
    check_decoded(outdir, flow_srcs)
    # the fused warm pair profiled (the level pair's launches are counted
    # above; its profile, an eager pass traced, took half a minute)
    profiles = {
        name: profile_pass(
            lambda p=p: [command(v, flow_srcs, False, p)
                         for v in ("compress", "decompress")],
            phase=f"cli_profile_{name}", top=6,
            want=each(len(batches) * cfg.nsplit))
        for name, p in (("fused", pipe),)}
    distinct = distinct_layouts(command, (pipe, level_pipe), flow_srcs,
                                cfg.nsplit)
    one_shot = one_shot_commands(config, ckpt, flow_srcs, len(batches)
                                 * cfg.nsplit)
    warm, dec = cmds[2]["ok_s"], cmds[5]["ok_s"]
    res = {"phase": "cli", "config": TRAIN_CONFIG, "num_streams": 4096,
           # the stored escape is stored-png with PIL, stored-zlib without
           "pil": importlib.util.find_spec("PIL") is not None,
           "startup_s": startup_s, "commands": cmds,
           "timer": C.TIMER.report(),
           "modes": {"flow_session": flow_stats,
                     "escape_session": lic_stats(esc_lics),
                     "mixed_decompress": mixed_stats},
           "chunk_batches": batches,
           "granularity": pipe.codec.granularity,
           **graph_stats([pipe.codec]),
           "kernel_shapes": coded_shapes(pipe.codec, batches),
           "compress_files_per_s": len(flow_srcs) / warm,
           "compress_tiles_per_s": tiles / warm,
           "decompress_files_per_s": len(flow_srcs) / dec,
           "decompress_tiles_per_s": tiles / dec,
           "level_commands": level_cmds,
           "idle_share": {name: prof["device_idle_share"]
                          for name, prof in profiles.items()},
           "profiled_launches": {name: prof["rans_calls"]
                                 for name, prof in profiles.items()},
           "distinct_layouts": distinct, "one_shot": one_shot,
           "bit_exact": True}
    emit(res)
    return res


def distinct_layouts(command, pipes, srcs, nsplit, sizes=(4, 5)):
    """A serve session whose every command meets a chunk layout not met
    before (the first `k` one-tile files, one chunk of one tile each), in
    each mode: compress then decompress per set.  The fused codec runs
    each eagerly and captures nothing, so its graphs and pool stay as they
    were."""
    out = {}
    for name, pipe in zip(("fused", "level"), pipes):
        before = graph_stats([pipe.codec])
        runs = []
        for k in sizes:
            for verb in ("compress", "decompress"):
                c = command(verb, srcs[:k], False, pipe)
                assert c["launches"] == {
                    n: nsplit if (n in DEC) == (verb == "decompress") else 0
                    for n in c["launches"]}, c
                runs.append({"files": k, "command": verb,
                             "ok_s": c["ok_s"]})
            check_decoded(os.path.join(CLI_DIR, "out"), srcs[:k])
        after = graph_stats([pipe.codec])
        assert after["captures"] == before["captures"], (before, after)
        out[name] = {"runs": runs, "total_s": sum(r["ok_s"] for r in runs),
                     "graphs_before": before, "graphs_after": after}
    return out


def one_shot_commands(config, ckpt, srcs, n_launch):
    """The file CLI in a fresh process per granularity (fused, level): a
    serve session of one compress and one decompress of `srcs`, each the
    first command of its chunk layout in its process, as a one-shot
    command is.  Per process: its wall, each command's `ok` seconds and
    its launches (`n_launch` of each kernel in each direction)."""
    out = {}
    for name in ("fused", "level"):
        d = os.path.join(CLI_DIR, f"one_shot_{name}")
        lics = [os.path.join(d, os.path.splitext(os.path.basename(p))[0]
                             + ".lic") for p, _ in srcs]
        session = (f"compress {d} " + " ".join(p for p, _ in srcs)
                   + f"\ndecompress {d} " + " ".join(lics) + "\nquit\n")
        t0 = time.time()
        child = subprocess.run(
            [sys.executable, "-c", CLI_CHILD, "serve", "--config", config,
             "--ckpt", ckpt, "--no-stored-fallback", "--ext", ".npy",
             "--granularity", name], input=session, cwd=ROOT, check=True,
            capture_output=True, text=True)
        wall = time.time() - t0
        lines = child.stdout.splitlines()
        launches = json.loads(lines[-1])
        oks = [float(ln.split()[1]) for ln in lines if ln.startswith("ok ")]
        assert len(oks) == 2, lines
        assert launches == each(n_launch), (name, launches)
        check_decoded(d, srcs)
        out[name] = {"process_s": wall, "compress_s": oks[0],
                     "decompress_s": oks[1], "launches": launches}
    emit({"phase": "cli_one_shot", **out})
    return out


def phase_residual(wrappers, batch: int = 16, queue: int = 4):
    """ResidualCodec over configs/resflow-cond-imagenet64.yaml at full
    width, then the same pipeline through the CLI."""
    from finalproject_losslessimagecompression_tpu_torch.cli import codec as C
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.container import (  # noqa: E501
        pack_streams_many,
    )
    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCfg,
        FlowCodec,
        IDFlow,
        ResidualCodec,
        build_vqvae_from_ref,
    )
    from finalproject_losslessimagecompression_tpu_torch.ops.dense_conv import (  # noqa: E501
        dense_conv3x3,
    )

    config = os.path.join(ROOT, RES_CONFIG)
    train = load_config(config)["train"]
    cfg = FlowCfg.from_ref(train["flows"])
    flow = perturbed(IDFlow(cfg, device="cuda", seed=0))
    vqvae = build_vqvae_from_ref(train["vqvae"], device="cuda", seed=2).eval()
    res = ResidualCodec(vqvae, FlowCodec(flow, num_streams=4096),
                        tuple(train["input_size"]))
    xs_np = images(batch, queue, seed=5)
    xs = [torch.from_numpy(x).cuda() for x in xs_np]
    warm(res, xs)

    for w in wrappers.values():
        w.launches = 0
    narrow0 = dense_conv3x3.narrow_launches
    t0 = time.time()
    packed = res.compress_many(xs)
    recs = res.decompress_many(packed, fetch=True)
    wall = time.time() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    assert all(v == cfg.nsplit for v in launches.values()), launches
    # 64-wide images: no DenseLayer takes the narrow geometry
    assert dense_conv3x3.narrow_launches == narrow0
    assert all(np.array_equal(r, x) for r, x in zip(recs, xs_np)), \
        "residual round trip is not bit-exact"
    numel = batch * queue * 64 * 64 * 3
    idx_bits = sum(8 * len(i) for i, _, _ in packed)
    res_bits = sum(FlowCodec.coded_bits(b) for _, b, _ in packed)

    # phase split of one more pass, each part fenced with synchronize
    idxs, t_vq = timed(lambda: [res._encode_idx(x) for x in xs])
    rec, t_rec = timed(lambda: [res._rec_from_idx(i) for i in idxs])
    per_batch, t_flow = timed(lambda: res.codec.encode_queue(
        [res._tiles(x - r) for x, r in zip(xs, rec)],
        [res._tiles(r) for r in rec]))
    _, t_pack = timed(lambda: (
        pack_streams_many([e for encs, _ in per_batch for e in encs]),
        torch.cat([i.reshape(-1) for i in idxs]).cpu()))
    _, t_dec = timed(lambda: res.decompress_many(packed, fetch=True))
    out = {"phase": "residual", "config": RES_CONFIG, "batch": batch,
           "queue": queue, "bit_exact": True,
           "images_per_s": batch * queue / wall, "wall_s": wall,
           "real_bpd": (idx_bits + res_bits) / numel,
           "index_bpd": idx_bits / numel, "residual_bpd": res_bits / numel,
           "indices_per_image": int(idxs[0][0].numel()),
           "phases_s": {"vq_encode": t_vq, "reconstruction": t_rec,
                        "flow_encode": t_flow, "pack": t_pack,
                        "decode": t_dec},
           "launches": launches, "granularity": res.codec.granularity,
           **graph_stats([res.codec]),
           "streams_per_level": [res.codec._level_S(lv, batch)
                                 for lv in range(cfg.nsplit)]}
    emit(out)
    out["profile"] = profile_pass(
        lambda: res.decompress_many(res.compress_many(xs), fetch=True),
        phase="residual_profile", want=launches)

    # the same pipeline through the CLI, the VQ checkpoint written here
    flow_ckpt = save_params(flow, os.path.join(CLI_DIR, "resflow.ckpt"))
    vq_ckpt = save_params(vqvae, os.path.join(CLI_DIR, "vqvae.ckpt"))
    srcs = write_images(os.path.join(CLI_DIR, "in_res"), [(64, 64, 3)] * 4, 6)
    outdir = os.path.join(CLI_DIR, "out_res")
    args = ["--config", config, "--ckpt", flow_ckpt, "--vq-ckpt", vq_ckpt,
            "--outdir", outdir, "--no-stored-fallback", "--ext", ".npy"]
    lics = [os.path.join(outdir, os.path.splitext(os.path.basename(p))[0]
                         + ".lic") for p, _ in srcs]
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        C.main(["compress", "--input", *[p for p, _ in srcs]] + args)
    runs = [{"command": "compress", "s": time.time() - t0,
             "launches": {n: w.launches for n, w in wrappers.items()}}]
    # the decompress in a process of its own, as a user runs it: the priors
    # rest on the VQ decoder's and the cond convs' output being the same
    # in both processes
    t0 = time.time()
    child = subprocess.run([sys.executable, "-c", CLI_CHILD, "decompress",
                            "--input", *lics] + args, cwd=ROOT, check=True,
                           capture_output=True, text=True)
    runs.append({"command": "decompress", "process": "child",
                 "s": time.time() - t0,
                 "launches": json.loads(child.stdout.splitlines()[-1])})
    check_decoded(outdir, srcs)
    cli_batches = C._chunk_sizes(1)  # each 64x64 file is one tile
    for r in runs:
        assert r["launches"] == {
            n: len(cli_batches) * cfg.nsplit if (n in DEC) == (
                r["command"] == "decompress") else 0
            for n in r["launches"]}, r
    emit({"phase": "residual_cli", "files": len(srcs), "runs": runs,
          "modes": lic_stats(lics), "bit_exact": True})
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    out["kernel_shapes"] = coded_shapes(res.codec, [batch] + cli_batches)
    return out


# ---------------------------------------------------------------------------
# phases 8-12: VQ-VAE and residual training, the two-level pyramid
# ---------------------------------------------------------------------------

VQ_CONFIG = "configs/vqvae_for_imagenet64_reinit.yaml"
TL_CONFIG = "configs/config_twolevel.yaml"
# the phases' checkpoints, logs and files, removed at the end
PIPE_DIR = os.path.join(ROOT, "logs", "chip_smoke_pipelines")


def launch_counts(wrappers):
    return {n: w.launches for n, w in wrappers.items()}


def reset_launches(wrappers):
    for w in wrappers.values():
        w.launches = 0


def trained(t, wrappers):
    """t.train() from zeroed launch counts and peak memory: (wall seconds,
    launches, peak GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(wrappers)
    t0 = time.time()
    t.train()
    torch.cuda.synchronize()
    return (time.time() - t0, launch_counts(wrappers),
            torch.cuda.max_memory_allocated() / 1e9)


def one_step_flops(t, loss_of_batch):
    """FLOPs of one training step's forward and backward (FlopCounterMode;
    the optimizer's elementwise update is not counted), on the trainer's
    first test batch (the train loader's order stays the eager twin's),
    leaving the parameters as they were."""
    from finalproject_losslessimagecompression_tpu_torch.utils.profiling import (  # noqa: E501
        step_flops,
    )

    batch = torch.from_numpy(np.asarray(next(iter(t.testloader)))).cuda()
    _, flops = step_flops(lambda: loss_of_batch(batch).backward())
    t.optimizer.zero_grad()
    return flops


def next_batch(t):
    """A trainer's next train batch on the card, as its loop copies it."""
    from finalproject_losslessimagecompression_tpu_torch.codec.interleaved import (  # noqa: E501
        to_device,
    )

    return to_device(torch.from_numpy(np.ascontiguousarray(
        np.asarray(next(t.trainloader)))), "cuda")


def twins_of(build_trainer, config):
    """A function that builds trainers from a copy of `config` as it is
    now (the twins of the trainer built from it)."""
    frozen = copy.deepcopy(config)
    return lambda: build_trainer(copy.deepcopy(frozen))


def mfu(flops, step_s):
    from finalproject_losslessimagecompression_tpu_torch.utils.profiling import (  # noqa: E501
        device_peak_tflops,
    )

    peak, name = device_peak_tflops("cuda", "float32")
    achieved = flops / step_s / 1e12
    return {"flops_per_step": flops, "achieved_tflops": achieved,
            "mfu_pct": 100.0 * achieved / peak if peak else None,
            "mfu_peak": name}


def resumed_equal(build_trainer, config, t, key):
    """A trainer built from the saved checkpoint (`key` of the train
    config's model subtree names it) equals t: params, optimizer state,
    step."""
    config = copy.deepcopy(config)
    config["train"][key]["load_path"] = t.save_path
    r = build_trainer(config)
    equal = same_state(t, r)
    if hasattr(t, "counts"):
        equal = equal and torch.equal(t.counts, r.counts)
    return equal


def phase_vqvae_train(wrappers, steps: int = 6):
    """configs/vqvae_for_imagenet64_reinit.yaml at full width through
    cli.train: `steps` steps at batch 32 with the dead-code reinit every
    time the counts pass 2, captured by default (step 1 eager, step 2
    captured, then replays), an epoch of 4 steps (the learning rate
    changes at step 5; eval of one batch at step 4), checkpoint and
    resume; then against an eager twin (`against_eager`)."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        apply_overrides,
        build_trainer,
        load_config,
    )

    d = os.path.join(PIPE_DIR, "vqvae")
    config = load_config(os.path.join(ROOT, VQ_CONFIG))
    batch = config["train"]["train_dataloader"]["batch_size"]
    config["train"]["train_dataloader"] = natural_loader(
        (64, 64), batch, steps * batch, 11, True)
    config["train"]["test_dataloader"] = natural_loader((64, 64), batch,
                                                        batch, 12, False)
    apply_overrides(config, [
        f"train.max_step={steps}", "train.evaluate_interval=4",
        f"train.save_interval={steps}", "train.step_per_epoch=4",
        "train.max_eval_batches=1", "train.log_every=1",
        "train.model.vectorquantizer.reinit_interval=2",
        f"train.save_path={d}/vqvae.ckpt", f"train.writer_path={d}/log"])
    t = build_trainer(config)
    twins = twins_of(build_trainer, config)
    assert t.graphs
    fill_caches(t)
    lrs = record_lrs(t.optimizer)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        wall, launches, peak_gb = trained(t, wrappers)
    log = os.path.join(d, "log")
    losses = [v for _, v in logged("train loss", log)]
    assert len(losses) == steps and all(map(math.isfinite, losses)), losses
    replaced = int(t.replaced)
    assert replaced > 0, "the dead-code reinit did not fire"
    test_bpd = logged("test bpd", log)[-1][1]
    assert math.isfinite(test_bpd)
    assert all(v == 0 for v in launches.values()), launches
    step = t.update_step
    assert (step.captures, step.replays) == (1, steps - 1)
    equal = resumed_equal(build_trainer, config, t, "model")
    assert equal, "a resumed VQ-VAE trainer differs from the saved one"
    rep = against_eager(
        "vqvae_train", t, step, twins, steps,
        lambda tw: tw.update_step.eager(next_batch(tw)),
        lambda: t.update(np.asarray(next(t.trainloader))), lrs, 1, batch,
        lambda tw: one_step_flops(tw, lambda b: tw.loss_fn(b)[0]))
    res = {"phase": "vqvae_train", "config": VQ_CONFIG, "batch": batch,
           "steps": t.step, "wall_s": wall, "step_s": rep["step_s"],
           "train_images_per_s": batch / rep["step_s"],
           "peak_mem_gb": peak_gb, "codewords_replaced": replaced,
           "reinit_reports": out.getvalue().count("vq re-init"),
           "train_bpd": [v for _, v in logged("train bpd", log)],
           "test_bpd": test_bpd, "resume_equal": equal, **rep}
    emit(res)
    return res, t.save_path


def phase_residual_train(wrappers, vq_ckpt: str, steps: int = 6,
                         patches: int = 2):
    """configs/resflow-cond-imagenet64.yaml at full width through
    cli.train, its VQ-VAE the checkpoint phase vqvae_train wrote: `steps`
    steps at batch 4, each on `patches` of the batch's patches drawn by
    the trainer's generator (`patch_batch_size`), captured by default, an
    epoch of 4 steps (the learning rate changes at step 5; eval with real
    coding through ResidualCodec at step 4), checkpoint and resume;
    then against an eager twin (`against_eager`, the generator's state
    included); then cli.make_res_data on two batches."""
    from finalproject_losslessimagecompression_tpu_torch.cli.make_res_data import (  # noqa: E501
        make_res_data,
    )
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        apply_overrides,
        build_trainer,
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.registry import (
        DATALOADERS,
        build,
    )

    d = os.path.join(PIPE_DIR, "residual")
    config = load_config(os.path.join(ROOT, RES_CONFIG))
    batch = config["train"]["train_dataloader"]["batch_size"]
    config["train"]["train_dataloader"] = natural_loader(
        (64, 64), batch, 4 * batch, 13, True)
    config["train"]["test_dataloader"] = natural_loader((64, 64), batch,
                                                        batch, 14, False)
    apply_overrides(config, [
        f"train.max_step={steps}", "train.evaluate_interval=4",
        f"train.save_interval={steps}", "train.step_per_epoch=4",
        f"train.patch_batch_size={patches}", "train.max_eval_batches=1",
        "train.log_every=1", "train.test_coding=true",
        f"train.vqvae.checkpoint={vq_ckpt}",
        f"train.save_path={d}/resflow.ckpt", f"train.writer_path={d}/log"])

    def built(c):
        t = build_trainer(c)
        perturbed(t.model, seed=15)
        return t

    t = built(config)
    twins = twins_of(built, config)
    assert t.graphs
    fill_caches(t)
    flops = one_step_flops(t, lambda b: t.loss_fn(
        *(x[:patches] for x in t._prepare(b)[:2]))[0])
    lrs = record_lrs(t.optimizer)
    wall, launches, peak_gb = trained(t, wrappers)
    log = os.path.join(d, "log")
    nsplit = t.cfg.nsplit
    errors = [v for _, v in logged("coding errors", log)]
    assert errors and all(e == 0 for e in errors), errors
    # training launches no kernel; each eval codes one batch through
    # ResidualCodec, one launch of each kernel per level
    assert all(v == nsplit * len(errors) for v in launches.values()), \
        launches
    step = t.train_step
    assert (step.captures, step.replays) == (1, steps - 1)
    equal = resumed_equal(build_trainer, config, t, "flows")
    assert equal, "a resumed residual trainer differs from the saved one"
    rep = against_eager(
        "residual_train", t, step, twins, steps,
        lambda tw: tw.train_step.eager(next_batch(tw)),
        lambda: t.train_step(next_batch(t)), lrs, 1, batch, flops)

    # cli.make_res_data on two batches of the train split
    out = os.path.join(d, "res_data.npz")
    make_res_data(config, out, max_batches=2, split="train_dataloader")
    npz = np.load(out)
    loader = build(DATALOADERS, config["train"]["train_dataloader"])
    data = np.concatenate([next(loader), next(loader)])
    res_data_exact = bool(np.array_equal(
        npz["residual"] + npz["reconstruction"], data))
    on_grid = bool(np.array_equal(np.round(npz["reconstruction"] * 256),
                                  npz["reconstruction"] * 256))
    assert res_data_exact and on_grid, (res_data_exact, on_grid)
    tiles = batch * (64 // t.cfg.H) * (64 // t.cfg.W)
    res = {"phase": "residual_train", "config": RES_CONFIG, "batch": batch,
           "patch_batch_size": patches, "steps": t.step, "wall_s": wall,
           "train_images_per_s": batch / rep["step_s"],
           "peak_mem_gb": peak_gb,
           "train_bpd": [v for _, v in logged("train bpd", log)],
           "test_bpd": logged("test bpd", log)[-1][1],
           "real_bpd": logged("real bpd", log)[-1][1],
           "coding_errors": int(sum(errors)), "eval_batches": len(errors),
           "launches_eval": {k: v // len(errors)
                             for k, v in launches.items()},
           "resume_equal": equal, **rep,
           "make_res_data": {"images": int(data.shape[0]),
                             "residual_plus_reconstruction_exact":
                             res_data_exact, "reconstruction_on_grid":
                             on_grid},
           "kernel_shapes": coded_shapes(t.codec, [tiles])}
    emit(res)
    return res


def natural_images(size, n: int, seed: int):
    """n NaturalSynthetic images of `size` (H, W) x 3 on the 1/256 grid."""
    from finalproject_losslessimagecompression_tpu_torch.data.datasets import (  # noqa: E501
        NaturalSynthetic,
    )

    ds = NaturalSynthetic(size=(*size, 3), length=n, seed=seed)
    return np.stack([np.round(ds[i] * 256) / np.float32(256)
                     for i in range(n)]).astype(np.float32)


def twolevel_images(n: int, seed: int):
    """n NaturalSynthetic 215x178x3 images on the 1/256 grid."""
    return natural_images((215, 178), n, seed)


def twolevel_shapes(codec, batches):
    """Every (S, k, seeded) a TwoLevelCodec codes batches of these sizes
    with: both sub-flows' stream policies."""
    per = (codec.Hc // codec.cfg.fine.H) * (codec.Wc // codec.cfg.fine.W)
    return coded_shapes(codec.rough_codec, batches) + coded_shapes(
        codec.fine_codec, [b * per for b in batches])


def phase_twolevel(wrappers, batch: int = 4, queue: int = 2):
    """TwoLevelCodec over configs/config_twolevel.yaml's model at full
    width (seeded weights, projections perturbed): compress_many then
    decompress_many(fetch=True) on a queue of `queue` batches of `batch`
    215x178 images, bit-exact, one launch of each kernel per sub-flow, and
    every DenseLayer of the fine sub-flow (4-wide rows) and none of the
    rough one's on the DenseLayer kernel's narrow geometry; then a
    torch.profiler pass.  Returns the result and the model."""
    from finalproject_losslessimagecompression_tpu_torch.models import (
        TwoLevelCodec,
    )
    from finalproject_losslessimagecompression_tpu_torch.ops import (
        dense_conv as D,
    )
    from finalproject_losslessimagecompression_tpu_torch.models.idflow import (  # noqa: E501
        log_likelihood,
    )
    from finalproject_losslessimagecompression_tpu_torch.models.twolevel import (  # noqa: E501
        twolevel_bpd,
    )

    cfg, model = twolevel_flow()
    codec = TwoLevelCodec(model, num_streams=4096)
    imgs = twolevel_images(batch * queue, 16)
    xs = [torch.from_numpy(imgs[i * batch:(i + 1) * batch]).cuda()
          for i in range(queue)]
    # warm-up: on the card the first call runs eagerly and the second
    # captures each direction's graphs, so the timed pass replays them
    for _ in range(2):
        codec.decompress_many(codec.compress_many(xs), fetch=True)
    torch.cuda.synchronize()

    reset_launches(wrappers)
    narrow0 = D.dense_conv3x3.narrow_launches
    packed, t_enc = timed(lambda: codec.compress_many(xs))
    recs, t_dec = timed(lambda: codec.decompress_many(packed, fetch=True))
    launches = launch_counts(wrappers)
    narrow = D.dense_conv3x3.narrow_launches - narrow0
    # one launch of each kernel per (sub-flow, level)
    nl = cfg.rough.nsplit + cfg.fine.nsplit
    assert all(v == nl for v in launches.values()), launches
    # the fine sub-flow's DenseLayers, each batch, each direction
    fine = cfg.fine
    fine_calls = (fine.couple.nn.depth * fine.nflows
                  + fine.prior_nn.depth) * fine.nsplit
    assert narrow == fine_calls * queue * 2, (narrow, fine_calls)
    assert all(np.array_equal(r, imgs[i * batch:(i + 1) * batch])
               for i, r in enumerate(recs)), "two-level round trip differs"
    with torch.no_grad():
        (rl, rm, rs), (fl, fm, fs) = model(xs[0])
        lr = -log_likelihood(cfg.rough, rl, rm, rs)[0].mean()
        lf = -log_likelihood(cfg.fine, fl, fm, fs)[0].mean()
    bpd1, bpd2 = float(lr) / math.log(2.0), float(lf) / math.log(2.0)
    wall = t_enc + t_dec
    nb = len(packed[0][0])
    res = {"phase": "twolevel", "config": TL_CONFIG, "batch": batch,
           "queue": queue, "geometry": {"image": [cfg.H, cfg.W],
                                        "coded": [codec.Hc, codec.Wc],
                                        "rough": [cfg.rough.H, cfg.rough.W],
                                        "fine_tiles_per_image":
                                        (codec.Hc // cfg.fine.H)
                                        * (codec.Wc // cfg.fine.W)},
           "bit_exact": True, "images_per_s": batch * queue / wall,
           "encode_s": t_enc, "decode_s": t_dec,
           "real_bpd": float(np.mean([codec.real_bpd(b, i)
                                      for b, i in packed])),
           "rough_bytes": sum(len(b) for p in packed
                              for b in p[0][:cfg.rough.nsplit]),
           "fine_bytes": sum(len(b) for p in packed
                             for b in p[0][cfg.rough.nsplit:]),
           "containers_per_batch": nb,
           "analytic_bpd": twolevel_bpd(cfg, bpd1, bpd2),
           "analytic_bpd_rough": bpd1, "analytic_bpd_fine": bpd2,
           "launches": launches, "dense_narrow_launches": narrow,
           "dense_fine_calls_per_batch": fine_calls,
           "kernel_shapes": twolevel_shapes(codec, [batch])}
    emit(res)
    profile_pass(lambda: codec.decompress_many(codec.compress_many(xs),
                                               fetch=True),
                 phase="twolevel_profile")
    return res, model


def phase_twolevel_train(wrappers, steps: int = 6):
    """configs/config_twolevel.yaml at full width through cli.train (batch
    4, the fine flow's activations recomputed in the backward pass):
    `steps` steps captured by default, an epoch of 4 steps (the learning
    rate changes at step 5; eval of one batch with real coding through
    TwoLevelCodec at step 4), samples at four temperatures,
    checkpoint and resume; then against an eager twin
    (`against_eager`)."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        apply_overrides,
        build_trainer,
        load_config,
    )

    d = os.path.join(PIPE_DIR, "twolevel")
    config = load_config(os.path.join(ROOT, TL_CONFIG))
    batch = config["train"]["train_dataloader"]["batch_size"]
    config["train"]["train_dataloader"] = natural_loader(
        (215, 178), batch, (steps + 1) * batch, 17, True)
    config["train"]["test_dataloader"] = natural_loader(
        (215, 178), batch, batch, 18, False)
    apply_overrides(config, [
        f"train.max_step={steps}", "train.evaluate_interval=4",
        f"train.save_interval={steps}", "train.step_per_epoch=4",
        "train.max_eval_batches=1", "train.log_every=1",
        "train.test_coding=true",
        f"train.save_path={d}/twolevel.ckpt", f"train.writer_path={d}/log"])

    def built(c):
        t = build_trainer(c)
        perturbed(t.model, seed=19)
        return t

    t = built(config)
    twins = twins_of(built, config)
    assert t.graphs
    fill_caches(t)
    flops = one_step_flops(t, lambda b: t.loss_fn(b)[0])
    lrs = record_lrs(t.optimizer)
    wall, launches, peak_gb = trained(t, wrappers)
    log = os.path.join(d, "log")
    cfg = t.cfg
    errors = [v for _, v in logged("coding errors", log)]
    assert errors and all(e == 0 for e in errors), errors
    nl = cfg.rough.nsplit + cfg.fine.nsplit
    assert all(v == nl * len(errors) for v in launches.values()), launches
    step = t.train_step
    assert (step.captures, step.replays) == (1, steps - 1)
    samples = t.sample_images()
    shapes = sorted({tuple(v.shape) for v in samples.values()})
    assert shapes == [(4, cfg.H, cfg.W, cfg.C)] and len(samples) == 4
    assert all(np.all(np.isfinite(v)) for v in samples.values())
    equal = resumed_equal(build_trainer, config, t, "model")
    assert equal, "a resumed two-level trainer differs from the saved one"
    rep = against_eager(
        "twolevel_train", t, step, twins, steps,
        lambda tw: tw.train_step.eager(next_batch(tw)),
        lambda: t.train_step(next_batch(t)), lrs, 1, batch, flops)
    res = {"phase": "twolevel_train", "config": TL_CONFIG, "batch": batch,
           "steps": t.step, "wall_s": wall,
           "train_images_per_s": batch / rep["step_s"],
           "peak_mem_gb": peak_gb,
           "train_bpd": [v for _, v in logged("train bpd", log)],
           "train_bpd_1": [v for _, v in logged("train bpd 1", log)],
           "train_bpd_2": [v for _, v in logged("train bpd 2", log)],
           "test_bpd": logged("test bpd", log)[-1][1],
           "real_bpd": logged("real bpd", log)[-1][1],
           "coding_errors": int(sum(errors)), "eval_batches": len(errors),
           "launches_eval": {k: v // len(errors)
                             for k, v in launches.items()},
           "sample_shapes": [list(s) for s in shapes],
           "resume_equal": equal, **rep}
    emit(res)
    return res


def phase_twolevel_cli(wrappers, model):
    """The file CLI's two-level pipeline at full width (the phase
    twolevel's model, saved as a checkpoint): two 215x178 .npy files and
    one 300x200 file (2 x 2 tiles, one chunk of 4) compressed in a serve
    session and decompressed by the CLI in a process of its own (its
    priors and cuDNN's algorithm choices made anew there), bit-exact."""
    from finalproject_losslessimagecompression_tpu_torch.cli import codec as C

    d = os.path.join(PIPE_DIR, "twolevel_cli")
    config = os.path.join(ROOT, TL_CONFIG)
    ckpt = save_params(model, os.path.join(d, "twolevel.ckpt"))
    srcs = write_images(os.path.join(d, "in"),
                        [(215, 178, 3), (215, 178, 3), (300, 200, 3)], 20)
    outdir = os.path.join(d, "out")
    lics = [os.path.join(outdir, os.path.splitext(os.path.basename(p))[0]
                         + ".lic") for p, _ in srcs]
    t0 = time.time()
    pipe = C._load_model(config, ckpt, 4096)
    torch.cuda.synchronize()
    startup_s = time.time() - t0
    batches = [1, 1, 4]
    # one launch of each coding kernel per sub-flow per stream layout (the
    # chunk sizes 1 and 4), in the command's direction only
    want = 2 * len(set(batches))
    reset_launches(wrappers)
    answer = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()):
        C.serve(pipe, lines=[f"compress {outdir} "
                             + " ".join(p for p, _ in srcs)],
                out=answer, stored_fallback=False, ext=".npy")
    reply = answer.getvalue().split()
    assert reply[0] == "ok", reply
    cmds = [{"command": "compress", "process": "serve", "files": len(srcs),
             "ok_s": float(reply[1]), "launches": launch_counts(wrappers)}]
    t0 = time.time()
    child = subprocess.run(
        [sys.executable, "-c", CLI_CHILD, "decompress", "--config", config,
         "--ckpt", ckpt, "--input", *lics, "--outdir", outdir,
         "--no-stored-fallback", "--ext", ".npy"],
        cwd=ROOT, check=True, capture_output=True, text=True)
    cmds.append({"command": "decompress", "process": "child",
                 "files": len(srcs), "s": time.time() - t0,
                 "launches": json.loads(child.stdout.splitlines()[-1])})
    for c in cmds:
        assert c["launches"] == {
            n: want if (n in DEC) == (c["command"] == "decompress") else 0
            for n in c["launches"]}, c
    check_decoded(outdir, srcs)
    res = {"phase": "twolevel_cli", "config": TL_CONFIG, "num_streams": 4096,
           "startup_s": startup_s, "commands": cmds,
           "modes": lic_stats(lics), "chunk_batches": sorted(set(batches)),
           "bit_exact": True, "decoded_in": "child process",
           "kernel_shapes": twolevel_shapes(pipe.codec, sorted(set(batches)))}
    emit(res)
    return res


def phase_pipelines(wrappers):
    """Phases 8-12, their files removed at the end."""
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    vq, vq_ckpt = phase_vqvae_train(wrappers)
    res_train = phase_residual_train(wrappers, vq_ckpt)
    twolevel, model = phase_twolevel(wrappers)
    tl_train = phase_twolevel_train(wrappers)
    tl_cli = phase_twolevel_cli(wrappers, model)
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    return {"vqvae_train": vq, "residual_train": res_train,
            "twolevel": twolevel, "twolevel_train": tl_train,
            "twolevel_cli": tl_cli}


# ---------------------------------------------------------------------------
# phases 14-16: the fine-tuner, the visualizer, growth-padded serving
# ---------------------------------------------------------------------------

FT_CONFIG = "configs/config-trans-test.yaml"
VIS_CONFIG = "configs/vis_config_imagenet64.yaml"
# the phases' checkpoints, logs and grids, removed at the end
TOOLS_DIR = os.path.join(ROOT, "logs", "chip_smoke_tools")


def phase_finetune(wrappers, ckpt: str, steps: int = 8):
    """configs/config-trans-test.yaml at full width through cli.train (the
    Finetuner: 64x48x3, nflows 8, nsplit 3, DenseBlocks 512 x 12, batch
    16), with the config's own Adamax and warm-up schedule in place of the
    constant fine_tune_lr, over epochs of 4 steps (the learning rate
    changes at step 5), its load_path `ckpt` (the flagship flow's weights:
    the same architecture, and a flow's weights do not depend on the image
    size), both loaders on NaturalSynthetic 64x48: `steps` tuning steps
    captured by default saving every 4, against an eager twin
    (`against_eager`), a resume check, then 3 steps with fine_tune off."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        apply_overrides,
        build_trainer,
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.utils.profiling import (  # noqa: E501
        step_flops,
    )

    t0 = time.time()
    d = os.path.join(TOOLS_DIR, "finetune")
    config = load_config(os.path.join(ROOT, FT_CONFIG))
    train = config["train"]
    batch = train["train_dataloader"]["batch_size"]
    size = tuple(train["train_dataloader"]["resize"])
    train["train_dataloader"] = natural_loader(size, batch, steps * batch,
                                               21, True)
    train["test_dataloader"] = natural_loader(size, batch, batch, 22, False)
    train["fine_tune_lr"] = None
    apply_overrides(config, [
        f"train.model.load_path={ckpt}", f"train.max_step={steps}",
        "train.save_interval=4", "train.evaluate_interval=4",
        "train.step_per_epoch=4",
        f"train.save_path={d}/ft.ckpt", f"train.writer_path={d}/log"])
    t = build_trainer(config)
    twins = twins_of(build_trainer, config)
    assert t.graphs
    fill_caches(t)
    frozen = {k: v.clone() for k, v in t.model.state_dict().items()}
    x = torch.from_numpy(np.asarray(next(iter(t.testloader)))).cuda()
    _, flops = step_flops(lambda: t.loss_fn(x).backward())
    t.tuner_opt.zero_grad()
    lrs = record_lrs(t.tuner_opt)
    wall, launches, peak_gb = trained(t, wrappers)
    log = os.path.join(d, "log")
    bpd = [v for _, v in logged("bpd", log)]
    assert len(bpd) == steps and all(map(math.isfinite, bpd)), bpd
    assert all(torch.equal(v, frozen[k])
               for k, v in t.model.state_dict().items()), "model moved"
    tuner_max = float(t.tuner.detach().abs().max())
    assert tuner_max > 0, "the tuner did not move"
    assert all(v == 0 for v in launches.values()), launches
    step = t.tune_step
    assert (step.captures, step.replays) == (1, steps - 1)
    r = build_trainer(apply_overrides(copy.deepcopy(config),
                                      ["train.resume=true"]))
    a, b = t.tuner_opt.state_dict(), r.tuner_opt.state_dict()
    resume_equal = (r.step == t.step == steps and a["count"] == b["count"]
                    and torch.equal(r.tuner, t.tuner)
                    and all(torch.equal(a["state"][0][k], b["state"][0][k])
                            for k in a["state"][0]))
    assert resume_equal, "a resumed fine-tuner differs from the saved one"
    del r
    rep = against_eager(
        "finetune", t, step, twins, steps,
        lambda tw: tw.tune_step.eager(next_batch(tw)),
        lambda: t.tune_step(next_batch(t)), lrs, 1, batch, flops)
    m = os.path.join(d, "measure")
    apply_overrides(config, [
        "train.resume=false", "train.fine_tune=false", "train.max_step=3",
        "train.save_interval=1", f"train.save_path={m}/ft.ckpt",
        f"train.writer_path={m}/log"])
    f = build_trainer(config)
    f.train()
    measured = [v for _, v in logged("bpd", os.path.join(m, "log"))]
    assert len(measured) == 3 and all(map(math.isfinite, measured))
    assert float(f.tuner.detach().abs().max()) == 0.0
    assert not os.path.exists(f.save_path), "measure-only run saved"
    res = {"phase": "finetune", "config": FT_CONFIG, "batch": batch,
           "image": [t.cfg.H, t.cfg.W, t.cfg.C], "steps": t.step,
           "wall_s": wall, "train_images_per_s": batch / rep["step_s"],
           "flops_counted": "forward and backward, input gradients only",
           "peak_mem_gb": peak_gb, "bpd_first": bpd[0], "bpd_last": bpd[-1],
           "bpd": bpd, "bpd_mean": [v for _, v in logged("bpd mean", log)],
           "tuner_max_abs": tuner_max, "model_frozen": True,
           "launches": launches, "resume_equal": resume_equal,
           "measure_only": {"steps": f.step, "bpd": measured,
                            "tuner_zero": True, "checkpoint_written": False},
           **rep, "phase_s": time.time() - t0}
    emit(res)
    return res


def phase_visualize(wrappers, ckpt: str, batch: int = 16, grid: int = 8):
    """cli.visualize on configs/vis_config_imagenet64.yaml at full width
    (the flagship 64x64 flow, its load_path `ckpt`): sample grids of
    `batch` at the four temperatures, each checked by the identity
    forward(sample) == the latents the sampler drew, then a grid x grid
    interpolation between four NaturalSynthetic corners."""
    from finalproject_losslessimagecompression_tpu_torch.cli import (
        visualize as V,
    )
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.utils.graphs import (
        set_deterministic_cuda,
    )
    from finalproject_losslessimagecompression_tpu_torch.ops.rounding import (
        round_to_grid,
    )
    from finalproject_losslessimagecompression_tpu_torch.train.metrics import (
        MetricsWriter,
    )

    t0 = time.time()
    d = os.path.join(TOOLS_DIR, "visualize")
    model_cfg = dict(load_config(os.path.join(ROOT, VIS_CONFIG))["train"][
        "model"], load_path=ckpt)
    # the identity below compares two evaluations of each prior
    set_deterministic_cuda()
    cfg, model = V.load_model(model_cfg)
    writer = MetricsWriter(d, use_tensorboard=False)
    noises = V.sample_noise(cfg, batch, torch.Generator(
        device="cuda").manual_seed(23))
    V.sample(cfg, model, writer, temperatures=(1.0,), noises=noises)  # warm
    reset_launches(wrappers)
    grids, exact = [], True
    for temp in V.TEMPERATURES:
        out, secs = timed(lambda: V.sample(cfg, model, writer, noises=noises,
                                           temperatures=(temp,)))
        img = out[temp]
        with torch.no_grad():
            lat, means, logscales = model(img)
        drawn = [round_to_grid(n * temp * torch.exp(ls) + m, cfg.nbits)
                 for n, m, ls in zip(noises, means, logscales)]
        same = all(torch.equal(a, b) for a, b in zip(lat, drawn))
        exact = exact and same
        grids.append({"temperature": temp, "s": secs,
                      "forward_equals_drawn_latents": same,
                      "finite": bool(torch.isfinite(img).all())})
    assert exact, grids
    corners = natural_images((cfg.H, cfg.W), 4, 24)
    imgs, interp_s = timed(lambda: V.interpolate(cfg, model, writer, corners,
                                                 grid=grid))
    assert tuple(imgs.shape) == (grid * grid, cfg.H, cfg.W, cfg.C)
    assert bool(torch.isfinite(imgs).all())
    on_grid = bool(torch.equal(torch.round(imgs * 256), imgs * 256))
    assert on_grid, "interpolated images are off the 1/256 grid"
    launches = launch_counts(wrappers)
    assert all(v == 0 for v in launches.values()), launches
    img_dir = os.path.join(d, "images")
    res = {"phase": "visualize", "config": VIS_CONFIG, "batch": batch,
           "samples": grids, "interpolate": {"grid": grid, "s": interp_s,
                                             "on_grid": on_grid},
           "grid_files": sorted(os.listdir(img_dir))
           if os.path.isdir(img_dir) else [],
           "pil": importlib.util.find_spec("PIL") is not None,
           "launches": launches, "phase_s": time.time() - t0}
    emit(res)
    return res


def growths(model):
    """The output channels of a flow's 3x3 convs (its priors')."""
    return sorted({layer.conv3_kernel.shape[0]
                   for blk in model.priors for layer in blk.net.layers})


def phase_padded(wrappers, flagship, e2e, multiples=(16, 64),
                 batch: int = 16, queue: int = 4):
    """The e2e serving pass with the e2e phase's weights zero-padded by
    pad_growth_params into the growth_multiple architecture (the same
    function with wider 3x3 convs): per multiple, compress_many then
    decompress_many(fetch=True) on the e2e phase's 4 x 16 queue, bit-exact,
    one launch of each coding kernel per level, then a torch.profiler pass
    (`profile_pass`) whose convolution device ms stand beside the e2e
    phase's profile of the unpadded model; the count of latents that
    differ from the unpadded model's (reported)."""
    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCodec,
        IDFlow,
        pad_growth_params,
        with_growth_multiple,
    )

    t0 = time.time()
    cfg, model, codec = flagship
    xs_np = images(batch, queue)
    xs = [torch.from_numpy(x).cuda() for x in xs_np]
    with torch.no_grad():
        base_lat = model(xs[0])[0]
    base = e2e["profile"]
    passes = [{"growth_multiple": 0, "conv_device_ms": base["conv_device_ms"],
               "device_busy_s": base["device_busy_s"],
               "images_per_s": e2e["images_per_s"],
               "growth_per_layer": growths(model)}]
    for mult in multiples:
        padded = IDFlow(with_growth_multiple(cfg, mult), device="cuda").eval()
        padded.load_state_dict(pad_growth_params(model.state_dict(), mult))
        pcodec = FlowCodec(padded, num_streams=8192)
        warm(pcodec, xs)  # the wider convs' cuDNN plans, the graphs
        reset_launches(wrappers)
        t1 = time.time()
        packed = pcodec.compress_many(xs)
        recs = pcodec.decompress_many(packed, fetch=True)
        wall = time.time() - t1
        launches = launch_counts(wrappers)
        assert all(v == cfg.nsplit for v in launches.values()), launches
        assert all(np.array_equal(r, x) for r, x in zip(recs, xs_np)), \
            f"growth_multiple {mult}: round trip is not bit-exact"
        with torch.no_grad():
            lat = padded(xs[0])[0]
        differ = sum(int((a != b).sum()) for a, b in zip(lat, base_lat))
        prof = profile_pass(
            lambda: pcodec.decompress_many(pcodec.compress_many(xs),
                                           fetch=True),
            phase=f"padded_profile_{mult}", top=8, want=launches)
        passes.append({
            "growth_multiple": mult, "bit_exact": True,
            "images_per_s": batch * queue / wall, "wall_s": wall,
            "real_bpd": float(np.mean([pcodec.real_bpd(b, i)
                                       for b, i in packed])),
            "launches": launches, "latents_differing": differ,
            "latents_total": sum(t.numel() for t in lat),
            "conv_device_ms": prof["conv_device_ms"],
            "rans_calls": prof["rans_calls"],
            "device_busy_s": prof["device_busy_s"],
            "device_idle_share": prof["device_idle_share"],
            "growth_per_layer": growths(padded)})
        del padded, pcodec
    res = {"phase": "padded", "batch": batch, "queue": queue,
           "passes": passes,
           "launches": {str(p["growth_multiple"]): p["launches"]
                        for p in passes[1:]},
           "kernel_shapes": coded_shapes(codec, [batch]),
           "phase_s": time.time() - t0}
    emit(res)
    return res


def phase_tools(wrappers, e2e):
    """Phases 14-16 on the flagship flow's seeded weights (phase 4's),
    saved once as the fine-tuner's and the visualizer's checkpoint; their
    files removed at the end."""
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    flagship = flagship_codec()
    ckpt = save_params(flagship[1], os.path.join(TOOLS_DIR, "flow.ckpt"))
    out = {"finetune": phase_finetune(wrappers, ckpt),
           "visualize": phase_visualize(wrappers, ckpt),
           "padded": phase_padded(wrappers, flagship, e2e)}
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 17: scale-out (parallel/ and cli/scaling.py)
# ---------------------------------------------------------------------------

# the ranks' results, checkpoints, logs and the scaling artifact, removed at
# the end
SCALE_DIR = os.path.join(ROOT, "logs", "chip_smoke_scaleout")
VQ_N = 2048  # VQ lookup queries: the 16 x 16 index grid of 8 images


def scaleout_codecs():
    """The three full-width codecs of the scale-out phase, seeded weights
    with perturbed projections (the same in every process): the flagship
    FlowCodec, ResidualCodec over configs/resflow-cond-imagenet64.yaml and
    TwoLevelCodec over configs/config_twolevel.yaml."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCfg,
        FlowCodec,
        IDFlow,
        ResidualCodec,
        TwoLevelCfg,
        TwoLevelCodec,
        TwoLevelFlow,
        build_vqvae_from_ref,
    )

    _, _, flagship = flagship_codec()
    train = load_config(os.path.join(ROOT, RES_CONFIG))["train"]
    flow = perturbed(IDFlow(FlowCfg.from_ref(train["flows"]), device="cuda",
                            seed=0))
    vqvae = build_vqvae_from_ref(train["vqvae"], device="cuda", seed=2).eval()
    res = ResidualCodec(vqvae, FlowCodec(flow, num_streams=4096),
                        tuple(train["input_size"]))
    cfg = TwoLevelCfg.from_ref(load_config(os.path.join(ROOT, TL_CONFIG))[
        "train"]["model"])
    tl = TwoLevelCodec(perturbed(TwoLevelFlow(cfg, device="cuda", seed=0)),
                       num_streams=4096)
    return flagship, res, tl


def scaleout_inputs():
    """The global batches: 32 flagship images, 16 residual images, 4
    two-level images (two ranks: 16, 8 and 2 each)."""
    return (images(32, 1, seed=21)[0], images(16, 1, seed=23)[0],
            twolevel_images(4, 24))


def vq_inputs():
    """Three sets of VQ_N queries with their 8192 x 512 codebooks:
    `near`, each query near a codeword, as a trained encoder's outputs lie
    (well apart from their second-nearest); `random`, N(0, 1) queries
    whose two nearest codewords can lie within rounding of each other;
    `tied`, queries near codewords 0..255 of a codebook whose rows
    4096..4351 (the second tile rank's first rows) repeat them, so that
    every query ties exactly across the two shards."""
    g = torch.Generator(device="cpu").manual_seed(25)
    cb = torch.randn(8192, 512, generator=g)
    pick = torch.randint(0, 8192, (VQ_N,), generator=g)
    near = cb[pick] + 0.1 * torch.randn(VQ_N, 512, generator=g)
    rand = torch.randn(VQ_N, 512, generator=g)
    tied_cb = cb.clone()
    tied_cb[4096:4096 + 256] = cb[:256]
    pick = torch.randint(0, 256, (VQ_N,), generator=g)
    tied = cb[pick] + 0.1 * torch.randn(VQ_N, 512, generator=g)
    return {"near": (near.cuda(), cb.cuda()),
            "random": (rand.cuda(), cb.cuda()),
            "tied": (tied.cuda(), tied_cb.cuda())}


def coded(wrappers, run):
    """(run(), launches, seconds): counts zeroed just before, read just
    after, the run fenced with synchronize."""
    torch.cuda.synchronize()
    reset_launches(wrappers)
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    return out, launch_counts(wrappers), time.time() - t0


def sharded_round_trip(wrappers, sharded, x):
    """One warm-up pass, then a compress and a decompress of the global
    batch x, each with its launch counts; the decode must return x on
    this rank exactly."""
    sharded.decompress(*sharded.compress(x), fetch=True)  # cuDNN, allocator
    out, enc_launches, enc_s = coded(wrappers, lambda: sharded.compress(x))
    rec, dec_launches, dec_s = coded(
        wrappers, lambda: sharded.decompress(*out, fetch=True))
    assert np.array_equal(rec, x), "sharded round trip is not bit-exact"
    return out, {"compress": enc_launches, "decompress": dec_launches,
                 "compress_s": enc_s, "decompress_s": dec_s}


def scaleout_nccl_rank(path, steps: int = 3):
    """(a) One NCCL rank on cuda:0: ShardedFlowCodec on the flagship at
    batch 16 against FlowCodec.compress of the batch, and `steps` sharded
    train steps of configs/imagenet64.yaml's model (captured: eager,
    capture, replay) against as many plain eager steps, bit for bit."""
    import torch.distributed as dist

    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        load_config,
    )
    from finalproject_losslessimagecompression_tpu_torch.models import (
        FlowCfg,
        IDFlow,
        log_likelihood,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel.flow_codec import (  # noqa: E501
        ShardedFlowCodec,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel.mesh import (  # noqa: E501
        init_distributed,
        make_mesh,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel.sharding import (  # noqa: E501
        make_sharded_train_step,
    )
    from finalproject_losslessimagecompression_tpu_torch.train.optim import (
        build_optimizer,
    )

    device = init_distributed("nccl", timeout_s=600.0)
    mesh = make_mesh()
    wrappers = kernel_wrappers()
    _, _, codec = flagship_codec()
    x = images(16, 1, seed=21)[0]
    sharded = ShardedFlowCodec(codec, mesh)
    (blobs, info), launches = sharded_round_trip(wrappers, sharded, x)
    solo, _ = codec.compress(torch.from_numpy(x).cuda())
    assert blobs == solo, "one-rank NCCL containers differ from FlowCodec's"

    train = load_config(os.path.join(ROOT, TRAIN_CONFIG))["train"]
    cfg = FlowCfg.from_ref(train["model"])
    batch = torch.from_numpy(images(16, 1, seed=26)[0]).cuda()
    models = [perturbed(IDFlow(cfg, device=device, seed=0))
              for _ in range(2)]
    opts = [build_optimizer(m.parameters(), train["optimizer"],
                            train["scheduler"], train["step_per_epoch"])
            for m in models]
    # the sharded step is captured (its first call eager, the second
    # captures and replays, the third replays), the NCCL all_reduce in its
    # graph; the plain steps are eager
    sharded = make_sharded_train_step(models[0], opts[0], mesh)
    step_s = [timed(lambda: sharded(batch))[1] for _ in range(steps)]
    for _ in range(steps):
        opts[1].zero_grad()
        lat, m, ls = models[1](batch)
        (-log_likelihood(cfg, lat, m, ls)[0].mean()).backward()
        opts[1].step()
    graphed = sharded.graphed
    assert graphed.graphs and (graphed.captures, graphed.replays) == (
        1, steps - 1), (graphed.captures, graphed.replays)
    equal = all(torch.equal(a, b) for a, b in zip(
        models[0].state_dict().values(), models[1].state_dict().values()))
    assert equal, "the one-rank sharded step differs from the plain step"
    with open(path, "w") as f:
        json.dump({"backend": dist.get_backend(), "world": mesh.size,
                   "device": str(device), "containers": len(blobs),
                   "byte_identical": True, "bit_exact": True,
                   "launches": launches, "train_step_equal": equal,
                   "train_steps": steps, "captures": graphed.captures,
                   "replays": graphed.replays,
                   "capture_s": graphed.capture_seconds,
                   "sharded_step_s": step_s,
                   "collective_calls": mesh.comm_calls}, f)
    dist.destroy_process_group()


def scaleout_gloo_rank(out_dir):
    """(b) One of two gloo ranks sharing cuda:0: the three sharded codecs
    at full width, the sharded Trainer, the sharded VQ lookup."""
    from finalproject_losslessimagecompression_tpu_torch.cli.train import (
        apply_overrides,
        build_trainer,
    )
    from finalproject_losslessimagecompression_tpu_torch.demo.multichip import (  # noqa: E501
        vq_check,
    )
    from finalproject_losslessimagecompression_tpu_torch.utils.graphs import (
        set_deterministic_cuda,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel.flow_codec import (  # noqa: E501
        ShardedFlowCodec,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel.full_codecs import (  # noqa: E501
        ShardedResidualCodec,
        ShardedTwoLevelCodec,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel.mesh import (  # noqa: E501
        init_distributed,
        make_mesh,
        shutdown,
    )
    from finalproject_losslessimagecompression_tpu_torch.parallel.multiproc import (  # noqa: E501
        params_sha256,
    )
    init_distributed("gloo", "cuda:0", timeout_s=600.0)
    set_deterministic_cuda()
    mesh = make_mesh()
    r = mesh.rank
    wrappers = kernel_wrappers()
    out = {"rank": r, "mesh": dict(mesh.shape)}
    flagship, res, tl = scaleout_codecs()
    x_flow, x_res, x_tl = scaleout_inputs()
    (out["flow_blobs"], _), out["flow"] = sharded_round_trip(
        wrappers, ShardedFlowCodec(flagship, mesh), x_flow)
    (out["res_idx"], out["res_blobs"], _), out["residual"] = \
        sharded_round_trip(wrappers, ShardedResidualCodec(res, mesh), x_res)
    (out["tl_blobs"], _), out["twolevel"] = sharded_round_trip(
        wrappers, ShardedTwoLevelCodec(tl, mesh), x_tl)
    del flagship, res, tl
    torch.cuda.empty_cache()

    # the sharded Trainer: configs/imagenet64.yaml, local batch 16
    d = os.path.join(SCALE_DIR, "train")
    config = train_config()
    config["train"]["train_dataloader"]["shard"] = True
    config["train"]["test_dataloader"]["shard"] = True
    apply_overrides(config, [
        "train.use_mesh=true", "train.evaluate_interval=1000",
        "train.max_step=4", "train.steps_per_dispatch=2",
        "train.log_every=2",
        f"train.save_path={d}/imagenet64.ckpt", f"train.writer_path={d}/log"])
    t = build_trainer(config)
    fill_caches(t)
    comm0 = t.mesh.comm_s
    with contextlib.redirect_stdout(io.StringIO()):
        _, train_launches, wall = coded(wrappers, t.train)
    comm_s = t.mesh.comm_s - comm0
    ev, eval_launches, eval_s = coded(wrappers, t.evaluate)
    out["trainer"] = {
        "steps": t.step, "local_batch": t.trainloader.batch_size,
        "wall_s": wall, "collective_host_ms_per_step":
        comm_s / t.step * 1e3,
        "launches_train": train_launches, "launches_eval": eval_launches,
        "eval_s": eval_s, "coding_errors": ev["coding_errors"],
        "real_bpd": ev["real_bpd"], "test_bpd": ev["test_bpd"],
        "params_sha256": params_sha256(t.model),
        "shard": [t.trainloader.shard_index, t.trainloader.shard_count]}
    del t
    torch.cuda.empty_cache()

    # the sharded VQ codebook search over the `tile` ranks of mesh (1, 2)
    tile = make_mesh((1, 2))
    out["vq"] = {name: vq_check(tile, x, cb)[0]
                 for name, (x, cb) in vq_inputs().items()}
    out["collective_calls"], out["collective_host_s"] = mesh.comm_calls, \
        mesh.comm_s
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))
    shutdown()


def reference_encodes():
    """This process's single-process compress of each of two ranks' shards
    with each scale-out codec: {part: [rank 0's, rank 1's]}, plus the
    launch shapes they code with."""
    flagship, res, tl = scaleout_codecs()
    x_flow, x_res, x_tl = scaleout_inputs()
    refs = {"flow": [], "residual": [], "twolevel": []}
    for r in range(2):
        refs["flow"].append(flagship.compress(torch.from_numpy(
            x_flow[16 * r:16 * r + 16]).cuda())[0])
        refs["residual"].append(res.compress(torch.from_numpy(
            x_res[8 * r:8 * r + 8]).cuda())[:2])
        refs["twolevel"].append(tl.compress(torch.from_numpy(
            x_tl[2 * r:2 * r + 2]).cuda())[0])
    # the trainer's eval codes 8 images per rank
    shapes = (coded_shapes(flagship, [16, 8]) + coded_shapes(res.codec, [8])
              + twolevel_shapes(tl, [2]))
    return refs, shapes


def checked_launch(name, n, t0, **kw):
    """parallel/multiproc.py's launcher: n ranks, 4 steps of local batch
    4, each rank's containers reproduced by its reference coder; the
    phase record."""
    from finalproject_losslessimagecompression_tpu_torch.parallel.multiproc import (  # noqa: E501
        launch,
    )

    mp = launch(n, steps=4, local_batch=4, timeout_s=300.0, **kw)
    assert mp["ok"] and mp["coding"]["byte_identical"] and \
        mp["coding"]["bit_exact"], mp
    assert mp["epoch_coverage"]["disjoint"], mp
    return {"phase": f"scaleout_multiproc_{name}", "ranks": n,
            **{k: mp[k] for k in ("collectives", "mesh_shape",
                                  "identical_loss_series", "collective_time",
                                  "wall_s")},
            "per_rank_container_sha256":
                mp["coding"]["per_rank_container_sha256"],
            "phase_s": time.time() - t0}


def phase_scaleout(wrappers, train):
    """Phase 17: (a) one NCCL rank, and beside it parallel/multiproc.py's
    launcher at its default (NCCL, a card a rank) with one rank, (b) two
    gloo ranks sharing the card, each rank's containers held against a
    single-process encode of its shard in this process (made while (a)
    runs; beside them phase 20's process, `multichip_report`), (c)
    cli/scaling.py's command line with two gloo ranks, overhead and weak
    mode at 1 and 2 ranks on the shared card, and beside it (d) the
    launcher with two gloo ranks on the card."""
    from concurrent.futures import ThreadPoolExecutor

    from finalproject_losslessimagecompression_tpu_torch.cli import scaling
    from finalproject_losslessimagecompression_tpu_torch.parallel.multiproc import (  # noqa: E501
        spawn_ranks,
    )

    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    os.makedirs(SCALE_DIR)
    torch.cuda.empty_cache()
    t0 = time.time()
    path = os.path.join(SCALE_DIR, "nccl.json")
    with ThreadPoolExecutor(2) as pool:
        nccl_run = pool.submit(spawn_ranks, scaleout_nccl_rank, 1, (path,),
                               600.0)
        launch_run = pool.submit(checked_launch, "nccl", 1, t0)
        refs, shapes = reference_encodes()
        nccl_run.result()
        mp_nccl = launch_run.result()
    torch.cuda.empty_cache()
    with open(path) as f:
        nccl = json.load(f)
    for direction, names in (("compress", ENC), ("decompress", DEC)):
        assert all(nccl["launches"][direction][n] == 3 for n in names), nccl
    emit({"phase": "scaleout_nccl", **nccl, "phase_s": time.time() - t0})
    emit(mp_nccl)

    # (b), and beside it phase 20's process (one NCCL rank)
    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        multichip_run = pool.submit(multichip_report)
        spawn_ranks(scaleout_gloo_rank, 2, (SCALE_DIR,), timeout_s=900.0)
        ranks_s = time.time() - t0
        multichip = multichip_run.result()
    ranks = [torch.load(os.path.join(SCALE_DIR, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    expect = {"flow": 3, "residual": 3, "twolevel": 2}
    for r, rank in enumerate(ranks):
        assert rank["flow_blobs"][3 * r:3 * r + 3] == refs["flow"][r], r
        idx_blob, blobs = refs["residual"][r]
        assert rank["res_idx"][r] == idx_blob, r
        assert rank["res_blobs"][3 * r:3 * r + 3] == blobs, r
        assert [rank["tl_blobs"][r], rank["tl_blobs"][2 + r]] == \
            refs["twolevel"][r], r
        for part, n in expect.items():
            for direction, names in (("compress", ENC),
                                     ("decompress", DEC)):
                assert all(rank[part][direction][k] == n for k in names), \
                    (r, part, rank[part])
        tr = rank["trainer"]
        assert tr["coding_errors"] == 0 and tr["steps"] == 4, tr
        assert all(tr["launches_eval"][k] == 3 for k in ENC + DEC), tr
        assert all(v == 0 for v in tr["launches_train"].values()), tr
        vq = rank["vq"]
        assert all(v["rows_equal"] and v["within_rounding"]
                   for v in vq.values()), vq
        assert vq["near"]["indices_equal_dense"], vq
        assert vq["tied"]["in_first_shard"], vq  # ties: lowest index
    assert ranks[0]["trainer"]["params_sha256"] == \
        ranks[1]["trainer"]["params_sha256"], "ranks' params differ"
    step_s = statistics.median(
        v for _, v in logged("step time s",
                             os.path.join(SCALE_DIR, "train", "log")))
    batch = 2 * ranks[0]["trainer"]["local_batch"]
    gloo = {
        "phase": "scaleout_gloo", "ranks": 2, "device": "cuda:0 (shared)",
        "byte_identical": True, "bit_exact": True,
        "launches": {f"{part}_rank{r}": {d: rank[part][d] for d in
                                        ("compress", "decompress")}
                     for r, rank in enumerate(ranks) for part in expect},
        "codec_s": {f"{part}_rank{r}": {d: rank[part][d + "_s"] for d in
                                       ("compress", "decompress")}
                    for r, rank in enumerate(ranks) for part in expect},
        "trainer": {**{k: v for k, v in ranks[0]["trainer"].items()
                       if k != "launches_train"},
                    "params_equal_on_ranks": True, "step_s": step_s,
                    "global_batch": batch,
                    "train_images_per_s": batch / step_s,
                    "phase_train_step_s": train["step_s"] if train else None},
        "vq": ranks[0]["vq"],
        "collective_host_s": [rank["collective_host_s"] for rank in ranks],
        "ranks_s": ranks_s,
        "kernel_shapes": shapes,
    }
    emit(gloo)

    # (c) cli/scaling.py as its command line runs it: two gloo ranks on
    # the card, spawned, the artifact read back (its printed copy is
    # kept out of this script's output); beside it (d) the launcher with
    # two gloo ranks on the card, so the two share it while they run
    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        gloo_launch = pool.submit(checked_launch, "gloo", 2, t0,
                                  device="cuda:0", backend="gloo")
        with contextlib.redirect_stdout(io.StringIO()):
            scaling_out = scaling.main(
                ["--nproc", "2", "--backend", "gloo", "--steps", "3",
                 "--timeout", "300", "--out",
                 os.path.join(SCALE_DIR, "scaling.json")])
        scaling_s = time.time() - t0
        mp_gloo = gloo_launch.result()
    assert scaling_out["weak_scaling_on_hardware"].startswith("unmeasured")
    assert scaling_out["n_devices"] == 2 and all(
        r["collective_host_ms"] > 0 for mode in ("overhead", "weak")
        for nd, r in scaling_out[mode].items() if nd != "1"), scaling_out
    emit({"phase": "scaleout_scaling", **{k: scaling_out[k] for k in (
        "device_name", "backend", "n_devices", "distinct_cards", "cards",
        "model", "per_device_batch", "overhead", "weak",
        "weak_scaling_on_hardware")}, "phase_s": scaling_s})
    emit(mp_gloo)
    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    return {"nccl": nccl, "gloo": gloo, "ranks": ranks,
            "kernel_shapes": gloo["kernel_shapes"], "multichip": multichip}


# ---------------------------------------------------------------------------
# phase 13: an 8M-symbol message
# ---------------------------------------------------------------------------


def phase_large(depth_ns, n: int = 8 * 2**20):
    """The kernels against their plain versions on an 8M-symbol message,
    then the whole encode and decode (layout, kernels, compaction) timed."""
    row = kernel_case(8192, n // 8192, seeded=False, seed=7,
                      depth_ns=depth_ns)
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        interleaved as IL,
    )
    from finalproject_losslessimagecompression_tpu_torch.codec.cdf import (
        NBINS,
        lower_bin,
    )

    v, m, s = message(n, 7, "cuda")
    lower = lower_bin(m)
    vc = torch.minimum(torch.maximum(v, lower), lower + NBINS - 1)
    enc = IL.interleaved_encode(v, m, s, num_streams=8192)
    vals, hi, lo = IL.interleaved_decode(enc, m, s)
    assert enc.num_streams == 8192 and IL._plan_steps(n, 8192) == 1024
    # the coder returns the window-clamped bins; the escapes' true values
    # ride in the container side channel
    assert int(enc.oow_count) == int((vc != v).sum())
    assert torch.equal(vals, vc), "8M-symbol decode is not bit-exact"
    assert bool((hi == 1).all()) and bool((lo == 0).all())
    enc_ms = cuda_ms(lambda: IL.interleaved_encode(v, m, s, 8192), 3)
    dec_ms = cuda_ms(lambda: IL.interleaved_decode(enc, m, s), 3)
    res = {"phase": "large", "symbols": n, "S": 8192, "k": 1024,
           "bit_exact": True, "num_words": int(enc.num_words),
           "encode_ms": enc_ms, "decode_ms": dec_ms,
           "encode_symbols_per_s": n / (enc_ms / 1e3),
           "decode_symbols_per_s": n / (dec_ms / 1e3)}
    emit(res)
    return row


# ---------------------------------------------------------------------------
# phase 18: the demo harnesses
# ---------------------------------------------------------------------------

DEMO_CONFIG = "configs/synthetic64.yaml"
DEMO_DIR = os.path.join(ROOT, "logs", "chip_smoke_demo")
DEMO_STEPS = 200
DEMO_TRAIN_LENGTH = 2048  # of the config's 8192 training images
STRESS_N = 50_000_000


def jax_reference():
    """The JAX package's recorded numbers this phase stands beside: its
    synthetic64 run's train bpd over steps 181-200
    (results/synthetic64_metrics.jsonl) and the 50M stress's coded bits
    per symbol (results/stress_50m_r05.json); bpd and bytes do not depend
    on the hardware."""
    bpd = [v for step, v in logged("train bpd", os.path.join(ROOT, "results"),
                                   "synthetic64_metrics.jsonl")
           if DEMO_STEPS - 19 <= step <= DEMO_STEPS]
    with open(os.path.join(ROOT, "results", "stress_50m_r05.json")) as f:
        stress_bits = json.load(f)["coded_bits_per_sym"]
    return {"train_bpd_181_200": sum(bpd) / len(bpd),
            "stress_coded_bits_per_sym": stress_bits}


@contextlib.contextmanager
def counted_command(wrappers, launches, name):
    """Launch counts of one demo command: zeroed just before it, read just
    after it into launches[name]."""
    reset_launches(wrappers)
    yield
    launches[name] = launch_counts(wrappers)


def demo_train(wrappers, ref):
    """cli.train on configs/synthetic64.yaml at full width for DEMO_STEPS
    captured steps (the training set cut to DEMO_TRAIN_LENGTH images),
    evaluated with real coding and saved at the last step."""
    from finalproject_losslessimagecompression_tpu_torch.cli import (
        train as cli_train,
    )

    ckpt = os.path.join(DEMO_DIR, "synthetic64.ckpt")
    log = os.path.join(DEMO_DIR, "log")
    cut = {"train.train_dataloader.dataset.length": DEMO_TRAIN_LENGTH,
           "train.max_step": DEMO_STEPS,
           "train.evaluate_interval": DEMO_STEPS,
           "train.save_interval": DEMO_STEPS}
    emit({"phase": "demo_cut", "config": DEMO_CONFIG, "set": cut,
          "why": "the training set cut from 8192 to 2048 images to save "
                 "host time; 200 of the config's 30000 steps"})
    argv = ["--config", os.path.join(ROOT, DEMO_CONFIG)]
    for key, value in [*cut.items(), ("train.save_path", ckpt),
                       ("train.writer_path", log)]:
        argv += ["--set", f"{key}={value}"]
    torch.cuda.synchronize()
    reset_launches(wrappers)
    t0 = time.time()
    t = cli_train.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts(wrappers)
    bpd = [v for step, v in logged("train bpd", log)
           if DEMO_STEPS - 19 <= step <= DEMO_STEPS]
    first = [v for step, v in logged("train bpd", log) if step <= 20]
    at = {tag: dict(logged(tag, log)).get(DEMO_STEPS)
          for tag in ("test bpd", "real bpd", "coding errors")}
    step_s = [v for _, v in logged("step time s", log)]
    res = {"phase": "demo_train", "steps": t.step, "wall_s": wall,
           "train_bpd_181_200": sum(bpd) / len(bpd),
           "jax_train_bpd_181_200": ref["train_bpd_181_200"],
           "train_bpd_17_20": sum(first) / len(first),
           "test_bpd": at["test bpd"], "real_bpd": at["real bpd"],
           "coding_errors": at["coding errors"],
           "step_s_median": statistics.median(step_s),
           "captures": t.train_multi.captures, "launches_eval": launches}
    emit(res)
    assert t.step == DEMO_STEPS and t.graphs
    assert all(v > 0 for v in launches.values()), launches
    assert res["coding_errors"] == 0, "demo training: coding errors"
    assert math.isfinite(res["real_bpd"]) and math.isfinite(res["test_bpd"])
    assert res["train_bpd_181_200"] < res["train_bpd_17_20"], \
        "demo training: the train bpd did not fall"
    return res, ckpt, t.codec


@contextlib.contextmanager
def without_pil():
    """PIL hidden from imports, as on a machine without it: the codec CLI
    then reads PNGs through the package's reader (utils/png.py) and its
    stored escape is stored-zlib."""
    names = ("PIL", "PIL.Image")
    saved = {n: sys.modules[n] for n in names if n in sys.modules}
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n in names:
            del sys.modules[n]
        sys.modules.update(saved)


def png_reader_check(corpus):
    """The package's PNG reader against PIL (where it imports) on every
    PNG of the corpus: exact, or None without PIL."""
    from finalproject_losslessimagecompression_tpu_torch.utils.png import (
        as_rgb,
        read_png,
    )

    try:
        from PIL import Image
    except ImportError:
        return None
    paths = sorted(os.path.join(corpus, f) for f in os.listdir(corpus)
                   if f.endswith(".png"))
    return all(np.array_equal(as_rgb(read_png(p)),
                              np.asarray(Image.open(p).convert("RGB")))
               for p in paths)


def demo_filecodec(wrappers, ckpt, corpus, name, hide_pil=False):
    """demo.filecodec_demo over a corpus with the trained checkpoint, each
    command's launches counted; with `hide_pil` PNGs are read through the
    package's own reader."""
    from finalproject_losslessimagecompression_tpu_torch.demo import (
        filecodec_demo,
    )

    launches = {}
    with without_pil() if hide_pil else contextlib.nullcontext():
        out = filecodec_demo.run(
            os.path.join(ROOT, DEMO_CONFIG), ckpt, corpus,
            workdir=os.path.join(DEMO_DIR, name),
            around=lambda c: counted_command(wrappers, launches, c))
    res = {"phase": f"demo_filecodec_{name}", "pil_hidden": hide_pil,
           **{k: v for k, v in out.items() if k != "files"},
           "files": {r["file"]: {k: r[k] for k in (
               "bit_exact", "lic_bytes", "png_bytes", "gzip9_bytes")}
               for r in out["files"]},
           "launches": launches}
    emit(res)
    assert out["all_bit_exact"], f"demo file codec ({name}) not bit-exact"
    # every compress command launches the encode kernels; a decompress
    # launches the decode only for flow containers (stored files: none)
    for c, counts in launches.items():
        if "decompress" not in c:
            assert all(counts[k] > 0 for k in ENC), (name, c, counts)
    return res


def demo_stress(wrappers, ref):
    """demo.stress at the reference's 50M symbols, one timed run of the
    host and the kernel path (the plain path is left to
    `stress_kernel_row`, which runs each plain version once on the same
    message and holds the kernels against it)."""
    from finalproject_losslessimagecompression_tpu_torch.demo import stress

    reset_launches(wrappers)
    out = stress.run(n=STRESS_N, iters=1, plain=False)
    launches = launch_counts(wrappers)
    res = {"phase": "demo_stress", **out,
           "jax_coded_bits_per_sym": ref["stress_coded_bits_per_sym"],
           "launches": launches}
    emit(res)
    assert out["bit_exact"] and out["kernel_bit_exact"]
    assert out["decode_windowed"] and out["steps"] == 6112
    assert abs(out["coded_bits_per_sym"]
               - ref["stress_coded_bits_per_sym"]) <= 1e-3, \
        "50M stress: coded size off the JAX package's"
    assert all(v == 2 for v in launches.values()), launches
    return res


def stress_kernel_row(depth_ns):
    """The three kernels against their plain versions on the stress's own
    50M-symbol message (S = 8192, k = 6112), each plain version run
    once."""
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        interleaved as IL,
    )
    from finalproject_losslessimagecompression_tpu_torch.demo import stress

    S = 8192
    k = IL._plan_steps(STRESS_N, S)
    v, m, s = (torch.from_numpy(a).cuda() for a in stress.draw(STRESS_N))
    vc, mk, sk, lower, *_ = IL._prepare_encode(v, m, s, S, k)
    del v, m, s
    return kernel_case(S, k, False, 6, depth_ns, inputs=(vc, mk, sk, lower))


def phase_demo(wrappers, depth_ns):
    """A model trained by the port coding the committed corpora, and the
    50M-symbol coder stress (files under logs/chip_smoke_demo, removed at
    the end)."""
    import gc

    t0 = time.time()
    shutil.rmtree(DEMO_DIR, ignore_errors=True)
    ref = jax_reference()
    train, ckpt, codec = demo_train(wrappers, ref)
    corpora = {
        "indomain": demo_filecodec(wrappers, ckpt, "indomain", "indomain"),
        "corpus": demo_filecodec(wrappers, ckpt,
                                 os.path.join(ROOT, "demo", "corpus"),
                                 "corpus", hide_pil=True),
    }
    reader = png_reader_check(os.path.join(ROOT, "demo", "corpus"))
    emit({"phase": "demo_png_reader", "equals_pil": reader})
    assert reader is not False, "PNG reader differs from PIL"
    gc.collect()
    torch.cuda.empty_cache()
    stress_res = demo_stress(wrappers, ref)
    gc.collect()
    torch.cuda.empty_cache()
    row = stress_kernel_row(depth_ns)
    shutil.rmtree(DEMO_DIR, ignore_errors=True)
    # every kernel of the path launched: in the training eval, the file
    # commands (a decompress of stored-escape files alone launches none)
    # and the stress
    for name in wrappers:
        total = (train["launches_eval"][name] + stress_res["launches"][name]
                 + sum(c[name] for r in corpora.values()
                       for c in r["launches"].values()))
        assert total > 0, f"demo path: {name} never launched"
    # the launch shapes of the path: eval batches of 8, the CLI's tile
    # chunks (the corpora's sizes; demo/corpus/ holds their transposes),
    # and the stress's own, held by `row`
    from finalproject_losslessimagecompression_tpu_torch.cli.codec import (
        _chunk_sizes,
    )
    from finalproject_losslessimagecompression_tpu_torch.demo.make_corpus import (  # noqa: E501
        SIZES,
    )

    H, W = codec.cfg.H, codec.cfg.W
    chunks = {b for _, (h, w) in SIZES
              for b in _chunk_sizes(-(-h // H) * -(-w // W))}
    shapes = coded_shapes(codec, sorted({8} | chunks))
    del codec
    res = {"phase": "demo", "wall_s": time.time() - t0,
           "train_bpd_181_200": train["train_bpd_181_200"],
           "jax_train_bpd_181_200": ref["train_bpd_181_200"],
           "test_bpd": train["test_bpd"], "real_bpd": train["real_bpd"],
           "coding_errors": train["coding_errors"],
           "lic_vs_png": {n: c["lic_vs_png"] for n, c in corpora.items()},
           "all_bit_exact": {n: c["all_bit_exact"]
                             for n, c in corpora.items()},
           "stress_bit_exact": {
               "host": stress_res["bit_exact"],
               "kernel": stress_res["kernel_bit_exact"],
               "plain": row["decode"]["max_abs_err"] == 0},
           "coded_bits_per_sym": stress_res["coded_bits_per_sym"],
           "jax_coded_bits_per_sym": ref["stress_coded_bits_per_sym"],
           "stress_sym_per_s": {
               "host": stress_res["host_sym_per_s"],
               "kernel": stress_res["kernel_device_sym_per_s"],
               # the plain versions' kernel-only times (no layout or
               # compaction), each run once
               "plain": STRESS_N / ((row["encode"]["plain_ms"]
                                     + row["decode"]["plain_ms"]) / 1e3)}}
    emit(res)
    return {"train": train, "corpora": corpora, "stress": stress_res,
            "row": row, "kernel_shapes": shapes}


# ---------------------------------------------------------------------------
# phase 19: the measurement harnesses
# ---------------------------------------------------------------------------

# the bench's sizes cut for the smoke (the JAX bench's are iters 5, steps
# 10, windows 3, latency iters 20); the float32 run's coder messages are
# cut too (the coder does not depend on the conv stack's dtype, and the
# bfloat16 run codes the full 1.2M and 8M symbols)
BENCH_CUT = ["--iters", "1", "--steps", "2", "--windows", "2",
             "--latency-iters", "3", "--queue", "2"]
BENCH_CUT_F32 = ["--f32", "--codec-n", "131072", "--large-n", "131072"]


def phase_bench(wrappers):
    """`bench.main` at the flagship in bfloat16 (its default) and with
    `--f32`, at BENCH_CUT; `demo.serving_roofline` at 8192 streams and a
    queue of 2; the
    padded function check at multiple 16; each one's launches counted
    from zero.  Both dtypes code bit-exactly and their containers differ."""
    import gc

    from finalproject_losslessimagecompression_tpu_torch import bench
    from finalproject_losslessimagecompression_tpu_torch.demo import (
        mfu_roofline_padded,
        serving_roofline,
    )

    t0 = time.time()
    launches, lines = {}, {}
    for dtype, flags in (("bf16", []), ("f32", BENCH_CUT_F32)):
        with counted_command(wrappers, launches, f"bench_{dtype}"):
            lines[dtype] = line = bench.main(BENCH_CUT + flags)
        emit({"phase": f"bench_{dtype}", "cut": BENCH_CUT + flags, **line})
        assert line["bit_exact"] and line["platform"] == "gpu", dtype
        assert line["bf16"] == (dtype == "bf16")
        assert line["e2e_launches_per_pass"] == each(3), line
        if dtype == "bf16":
            assert line["codec_streams_steps"] == [8192, 144]
            assert line["codec_large_ring_windowed"]
        gc.collect()
        torch.cuda.empty_cache()
    assert (lines["bf16"]["e2e_containers_sha256"]
            != lines["f32"]["e2e_containers_sha256"]), \
        "bf16 and f32 containers are equal: the bf16 stack did not run"
    with counted_command(wrappers, launches, "serving_roofline"):
        serving = serving_roofline.run(queue=2, iters=1, streams=(8192,))
    emit({"phase": "bench_serving_roofline", **serving})
    assert serving["nn_inverse_reconstructs"]
    assert serving["bf16_serving_probe"]["bit_exact"]
    gc.collect()
    torch.cuda.empty_cache()
    with counted_command(wrappers, launches, "padded_check_16"):
        cfg, model = bench.build_model(False, bf16=False, device="cuda")
        check = mfu_roofline_padded.function_check(cfg, model, 16)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "bench_padded_check", **check})
    assert check["padded_codec_bit_exact"]
    for name in wrappers:
        assert sum(c[name] for c in launches.values()) > 0, \
            f"bench path: {name} never launched"
    shapes = {tuple(x) for line in lines.values()
              for x in line["kernel_shapes"]}
    shapes |= {tuple(x) for x in serving["rans_level_shapes"]}
    shapes |= {tuple(x) for x in check["kernel_shapes"]}
    res = {"phase": "bench", "wall_s": time.time() - t0,
           "images_per_s": {d: ln["value"] for d, ln in lines.items()},
           "level_images_per_s": {d: ln["e2e_level_images_per_s"]
                                  for d, ln in lines.items()},
           "device_idle_share": {d: ln["device_idle_share"]
                                 for d, ln in lines.items()},
           "train_mfu_pct": {d: ln["train_mfu_pct"]
                             for d, ln in lines.items()},
           "launches": launches,
           "kernel_shapes": [list(x) for x in sorted(shapes)]}
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 20: the multi-chip dry run as one NCCL rank
# ---------------------------------------------------------------------------


def multichip_report():
    """Phase 20's run: `demo.multichip --nproc 1` in a process of its own
    (its checks raise there) -> (its report, its seconds)."""
    t0 = time.time()
    path = os.path.join(ROOT, "logs", "chip_smoke_multichip.json")
    if os.path.exists(path):
        os.remove(path)
    proc = subprocess.run(
        [sys.executable, "-m",
         "finalproject_losslessimagecompression_tpu_torch.demo.multichip",
         "--nproc", "1", "--out", path], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path) as f:
        rep = json.load(f)
    os.remove(path)
    return rep, time.time() - t0


def phase_multichip(rep, seconds):
    """Phase 20: the report of `multichip_report` (run beside phase
    17(b)).  One launch of each coding kernel each way for the raw rANS,
    nsplit (2) for each codec, as the rank counted them (its counts
    zeroed just before each part)."""
    launches = rep["launches_per_rank"][0]
    for part, n in (("rans", 1), ("flow_codec", 2), ("residual_codec", 2)):
        for d, names in (("compress", ENC), ("decompress", DEC)):
            assert all(launches[part][d][k] == (n if k in names else 0)
                       for k in launches[part][d]), (part, launches[part])
    tr = rep["train"]
    assert tr["captured"] and tr["equal_to_eager_twin"], tr
    shapes = {tuple(x) for part in ("rans", "flow_codec", "residual_codec")
              for x in rep[part]["kernel_shapes"]}
    # the four-card --full run's ranks code at phase 3's flagship level
    # shapes, and their raw rANS at the shape of 196,608 symbols
    from finalproject_losslessimagecompression_tpu_torch.codec import (
        interleaved as IL,
    )
    from finalproject_losslessimagecompression_tpu_torch.demo.multichip import (  # noqa: E501
        SIZES,
    )

    n, S = SIZES["full"]["rans_per_rank"], SIZES["full"]["rans_streams"]
    S = IL.pick_num_streams(n, S)
    shapes.add((S, IL._plan_steps(n, S), False))
    shapes = sorted(shapes)
    emit({"phase": "multichip", "mesh": rep["mesh"],
          "backend": rep["backend"], "cards": rep["cards"],
          "entry_loss": rep["entry_loss"],
          "train": {k: tr[k] for k in (
              "losses", "loss_max_rel_diff", "step_s", "capture_s",
              "captures", "replays", "collective_device_ms",
              "against_plain_first_step",
              "against_plain")},
          "vq": {k: {m: v[m] for m in ("indices_differ_dense",
                                       "within_rounding")}
                 for k, v in rep["vq"].items()},
          **{part: {k: rep[part][k] for k in (
              "compress_s", "decompress_s", "bytes")}
             for part in ("rans", "flow_codec", "residual_codec")},
          "real_bpd": {part: rep[part]["real_bpd"] for part in (
              "flow_codec", "residual_codec")},
          "kernels_against_plain": rep["kernels_against_plain"],
          "launches": launches, "rank_wall_s": rep["rank_wall_s"],
          "phase_s": seconds})
    return {"launches": launches, "kernel_shapes": [list(x)
                                                    for x in shapes]}


# ---------------------------------------------------------------------------


def launches_scaleout(scaleout, name):
    """A kernel's launch counts in phase 17, by part, rank and direction."""
    out = {f"flow_nccl_{d}": scaleout["nccl"]["launches"][d][name]
           for d in ("compress", "decompress")}
    for r, rank in enumerate(scaleout["ranks"]):
        for part in ("flow", "residual", "twolevel"):
            for d in ("compress", "decompress"):
                out[f"{part}_gloo_rank{r}_{d}"] = rank[part][d][name]
        out[f"trainer_eval_gloo_rank{r}"] = \
            rank["trainer"]["launches_eval"][name]
    return out


def launches_fused(fused, name):
    """A kernel's launch counts in phase 4b, by codec and case."""
    return {"flagship": fused["flagship"]["launches"][name],
            "flagship_first_call": fused["flagship"][
                "launches_first_call"][name],
            "flagship_capture_call": fused["flagship"][
                "launches_capture_call"][name],
            "escapes_level_path": fused["escapes"]["max_outliers_4"][
                "launches"][name],
            "escapes_in_graph": fused["escapes"]["max_outliers_256"][
                "launches"][name],
            "residual": fused["residual"]["launches"][name],
            "twolevel": fused["twolevel"]["launches"][name]}


def launches_profiled(e2e, fused, cli, residual, tools, name):
    """A kernel's launches as the profiler recorded them on the device in
    the profiled passes of the main paths (replayed graphs under the fused
    default; each was asserted equal to the wrappers' counts)."""
    out = {}
    if e2e:
        out["e2e"] = e2e["profile"]["rans_calls"][name]
    if fused:
        for mode, calls in fused["flagship"]["profiled_launches"].items():
            out[f"flagship_{mode}"] = calls[name]
        for mode, calls in fused["residual"]["profiled_launches"].items():
            out[f"residual_{mode}"] = calls[name]
    if cli:
        for mode, calls in cli["profiled_launches"].items():
            out[f"cli_{mode}"] = calls[name]
    if residual:
        out["residual"] = residual["profile"]["rans_calls"][name]
    if tools:
        for p in tools["padded"]["passes"][1:]:
            out[f"padded_{p['growth_multiple']}"] = p["rans_calls"][name]
    return out or None


def launches_demo(demo, name):
    """A kernel's launch counts in phase 18, by command."""
    out = {"train_eval": demo["train"]["launches_eval"][name]}
    for corpus, res in demo["corpora"].items():
        for c, counts in res["launches"].items():
            out[f"filecodec_{corpus}_{c}"] = counts[name]
    out["stress"] = demo["stress"]["launches"][name]
    return out


def kernels_line(rows, e2e, fused, train, cli, residual, pipes, tools,
                 scaleout, demo, bench, multichip):
    head = [r for r in rows if r["S"] == 384 and not r["seeded"]][0]
    out = []
    for key, name, replaces, extra in (
        ("prepass", "rans_cdf_prepass_kernel", f"{TPU_KERNELS}:214", {}),
        ("encode", "rans_encode_kernel", f"{TPU_KERNELS}:199",
         {"ms_includes": "rans_cdf_prepass_kernel"}),
        ("decode", "rans_decode_kernel", f"{TPU_KERNELS}:347",
         {"also_replaces": f"{TPU_KERNELS}:382"}),
    ):
        h = head[key]
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, **extra,
            "launches": e2e["launches"][name] if e2e else None,
            "launches_profiled": launches_profiled(e2e, fused, cli,
                                                   residual, tools, name),
            "launches_fused": (launches_fused(fused, name) if fused
                               else None),
            "launches_train_eval": (train["launches_eval"][name] if train
                                    else None),
            "launches_cli": ({c["command"] + str(i): c["launches"][name]
                              for i, c in enumerate(cli["commands"])}
                             if cli else None),
            "launches_residual": (residual["launches"][name] if residual
                                  else None),
            "launches_residual_train_eval": (
                pipes["residual_train"]["launches_eval"][name] if pipes
                else None),
            "launches_twolevel": (pipes["twolevel"]["launches"][name]
                                  if pipes else None),
            "launches_twolevel_train_eval": (
                pipes["twolevel_train"]["launches_eval"][name] if pipes
                else None),
            "launches_twolevel_cli": (
                {c["command"]: c["launches"][name]
                 for c in pipes["twolevel_cli"]["commands"]} if pipes
                else None),
            "launches_padded": (
                {m: v[name] for m, v in tools["padded"]["launches"].items()}
                if tools else None),
            "launches_scaleout": (launches_scaleout(scaleout, name)
                                  if scaleout else None),
            "launches_demo": launches_demo(demo, name) if demo else None,
            "launches_bench": ({c: v[name] for c, v in
                                bench["launches"].items()} if bench
                               else None),
            "launches_multichip": (
                {f"{part}_{d}": v[d][name]
                 for part, v in multichip["launches"].items() for d in v}
                if multichip else None),
            "max_abs_err": max(r[key]["max_abs_err"] for r in rows),
            "matches_plain": all(r[key]["max_abs_err"] == 0 for r in rows),
            "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "depth_bound_ms": h["depth_bound_ms"],
            "library_ms": None,
            "shapes": [{"S": r["S"], "k": r["k"], "seeded": r["seeded"],
                        "ms": r[key]["ms"], "plain_ms": r[key]["plain_ms"],
                        "bound_ms": r[key]["bound_ms"],
                        "depth_bound_ms": r[key]["depth_bound_ms"]}
                       for r in rows],
        })
    return {"kernels": out}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_device()
    if "--dense" in argv:
        phase_dense()
        print(smi, flush=True)
        return 0
    depth_ns = phase_depth()
    rows, _, _ = phase_kernels(depth_ns)
    phase_dense()
    e2e = fused = train = cli = residual = pipes = tools = scaleout = None
    demo = bench = multichip = None
    if "--quick" not in argv:
        e2e = phase_e2e()
        fused = phase_fused(kernel_wrappers(), queue=2)
        train = phase_train(kernel_wrappers())
        cli = phase_cli(kernel_wrappers())
        residual = phase_residual(kernel_wrappers())
        pipes = phase_pipelines(kernel_wrappers())
        path_kernels(rows, (e2e, cli, residual, pipes["residual_train"],
                            pipes["twolevel"], pipes["twolevel_cli"]),
                     depth_ns)
        rows.append(phase_large(depth_ns))
        tools = phase_tools(kernel_wrappers(), e2e)
        scaleout = phase_scaleout(kernel_wrappers(), train)
        path_kernels(rows, (tools["padded"], scaleout), depth_ns)
        demo = phase_demo(kernel_wrappers(), depth_ns)
        rows.append(demo["row"])
        path_kernels(rows, (demo,), depth_ns)
        bench = phase_bench(kernel_wrappers())
        path_kernels(rows, (bench,), depth_ns)
        multichip = phase_multichip(*scaleout["multichip"])
        path_kernels(rows, (multichip,), depth_ns)
    emit(kernels_line(rows, e2e, fused, train, cli, residual, pipes, tools,
                      scaleout, demo, bench, multichip))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
