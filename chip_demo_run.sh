#!/bin/bash
# The demo harnesses' and the measurement harnesses' long runs on one GPU,
# from the repository root:
#
#     bash chip_demo_run.sh [OUTDIR] [all|demo|bench|multichip]
#                                          # default logs/demo_run all
#
# demo: 5000 steps each of configs/synthetic64.yaml and
# configs/natural64.yaml (checkpoints under logs/long), one eval of each
# checkpoint (demo.eval_phases, the 4 test batches), demo.filecodec_demo
# with the synthetic64 model over the in-domain and natural corpora and
# demo/corpus/, and with the natural64 model over the natural corpus, then
# demo.stress at 50M symbols (3 timed runs per device path).  About 25
# minutes on an H100.
#
# bench: the port's bench at the JAX bench's defaults in bfloat16 (its
# default) and float32 (bench_flagship_bf16.json, bench_flagship_f32.json),
# then demo.serving_roofline, demo.mfu_roofline and
# demo.mfu_roofline_padded at the JAX scripts' defaults
# (serving_roofline.json, mfu_roofline.json, mfu_roofline_padded.json).
# About 20 minutes on an H100.
#
# multichip (not part of all; needs at least four visible GPUs and fails
# otherwise): demo.multichip over 4 NCCL ranks, one card each, at the full
# width of configs/resflow-cond-imagenet64.yaml and at JAX's parity size
# (multichip_4x.json, multichip_4x_parity.json); cli.scaling at the bench
# flagship's widths in float32 (64x64, nflows 8, nsplit 3, DenseBlocks
# 512 x 12, 16 images a rank), overhead and weak mode over 1, 2 and 4 NCCL
# ranks (scaling_4x.json); parallel.multiproc's launcher with 4 NCCL ranks
# and its single-process reference coder (multiproc_4x.json).  About 6
# minutes on four H100s.
#
# Each step's output goes to OUTDIR/<step>.log, its JSON to
# OUTDIR/<step>.json, the training metrics to OUTDIR/log_<config>/
# metrics.jsonl; OUTDIR/steps.txt lists each step's exit code and seconds.
P=finalproject_losslessimagecompression_tpu_torch
O=${1:-logs/demo_run}
PARTS=${2:-all}
mkdir -p $O logs/long
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $O/nvidia_smi.txt
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' | tee $O/versions.txt
run() { name=$1; shift; s0=$SECONDS; "$@" > $O/$name.log 2>&1; rc=$?;
        echo "$name rc=$rc s=$((SECONDS - s0))" | tee -a $O/steps.txt; tail -n 3 $O/$name.log; }
if [ "$PARTS" = all ] || [ "$PARTS" = demo ]; then
  for m in synthetic64 natural64; do
    run train_$m python -m $P.cli.train --config configs/$m.yaml \
        --set train.max_step=5000 --set train.save_path=logs/long/$m.ckpt \
        --set train.writer_path=$O/log_$m
    run eval_$m python -m $P.demo.eval_phases --config configs/$m.yaml \
        --ckpt logs/long/$m.ckpt --batches 4 --out $O/eval_phases_$m.json
  done
  for c in indomain natural demo/corpus; do
    n=$(basename $c)
    run filecodec_synthetic64_$n python -m $P.demo.filecodec_demo \
        --config configs/synthetic64.yaml --ckpt logs/long/synthetic64.ckpt \
        --corpus $c --out $O/filecodec_synthetic64_$n.json
  done
  run filecodec_natural64_natural python -m $P.demo.filecodec_demo \
      --config configs/natural64.yaml --ckpt logs/long/natural64.ckpt \
      --corpus natural --out $O/filecodec_natural64_natural.json
  run stress python -m $P.demo.stress --iters 3 --out $O/stress_50m.json
  rm -f $O/log_*/events.out.tfevents.*
fi
if [ "$PARTS" = all ] || [ "$PARTS" = bench ]; then
  run bench_flagship_bf16 python -m $P.bench --out $O/bench_flagship_bf16.json
  run bench_flagship_f32 python -m $P.bench --f32 --out $O/bench_flagship_f32.json
  run serving_roofline python -m $P.demo.serving_roofline \
      --out $O/serving_roofline.json
  run mfu_roofline python -m $P.demo.mfu_roofline --out $O/mfu_roofline.json
  run mfu_roofline_padded python -m $P.demo.mfu_roofline_padded \
      --out $O/mfu_roofline_padded.json
fi
if [ "$PARTS" = multichip ]; then
  cards=$(nvidia-smi --query-gpu=name --format=csv,noheader | wc -l)
  if [ "$cards" -lt 4 ]; then
    echo "multichip needs four GPUs, $cards visible" >&2
    exit 1
  fi
  nvidia-smi --query-gpu=index,name,power.limit --format=csv,noheader \
      | tee $O/nvidia_smi_4x.txt
  # build the kernels once, before four ranks would each want them
  run build python -c "from $P.codec import container, cuda_rans; \
cuda_rans.build(); container._chain()"
  # each step bounded: a hung collective fails within its group timeout
  run multichip_4x timeout 240 python -m $P.demo.multichip --nproc 4 \
      --full --timeout 200 --out $O/multichip_4x.json
  run multichip_4x_parity timeout 90 python -m $P.demo.multichip \
      --nproc 4 --timeout 60 --out $O/multichip_4x_parity.json
  run scaling_4x timeout 360 python -m $P.cli.scaling --nproc 4 --size 64 \
      --nflows 8 --nsplit 3 --growth 512 --depth 12 --batch 16 --steps 5 \
      --timeout 330 --out $O/scaling_4x.json
  run multiproc_4x timeout 120 sh -c "python -m $P.parallel.multiproc \
      --launch 4 --timeout 90 > $O/multiproc_4x.json"
fi
cat $O/steps.txt
