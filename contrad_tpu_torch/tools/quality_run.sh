#!/usr/bin/env bash
# Quality runbook of the PyTorch port: the north-star CIFAR-10 FID number,
# one command (the port of tools/quality_run.sh). Every stage runs a module
# of contrad_tpu_torch.
#
# With CIFAR-10 under $DATA_DIR and the Inception FID weights in place, it
# runs the reference's flagship quality protocol (SNDCGAN + ContraD, FID@10k):
#
#   DATA_DIR=data/ contrad_tpu_torch/tools/quality_run.sh       # 10k steps
#   STEPS=100000 contrad_tpu_torch/tools/quality_run.sh         # paper length
#   EMBED=moments DATASET=synthetic_32 contrad_tpu_torch/tools/quality_run.sh
#       # the weights-free dry run
#   DEVICE=cpu EMBED=moments DATASET=synthetic_16 STEPS=4 EVAL_EVERY=4 \
#       FID_SIZE=16 EXTRA_OVERRIDES=options.batch_size=8 \
#       contrad_tpu_torch/tools/quality_run.sh    # the dry run on the CPU
#
# Stages: asset check -> FID reference statistics -> flagship training with
# in-loop FID -> FID trajectory -> cross-check of the final number by both
# Inception embedders (inception only). Nothing is downloaded: the asset
# check names the missing files and stops.
#
# Variables: DATA_DIR DATASET EMBED STEPS EVAL_EVERY FID_SIZE LOGROOT
# EXTRA_FLAGS (train_gan flags, no --override) EXTRA_OVERRIDES (options.*)
# CROSSCHECK (0 skips stage 5) DEVICE (cuda, or cpu). The statistics go to
# $FID_STATS_DIR where set, else third_party/fid/.
set -euo pipefail
cd "$(dirname "$0")/../.."

DATA_DIR="${DATA_DIR:-data/}"
DATASET="${DATASET:-cifar10}"
EMBED="${EMBED:-inception}"
STEPS="${STEPS:-10000}"
EVAL_EVERY="${EVAL_EVERY:-2000}"
FID_SIZE="${FID_SIZE:-10000}"
LOGROOT="${LOGROOT:-logs/quality}"
EXTRA_FLAGS="${EXTRA_FLAGS:-}"
EXTRA_OVERRIDES="${EXTRA_OVERRIDES:-}"
DEVICE="${DEVICE:-cuda}"
export DATA_DIR

echo "== [1/5] asset check (dataset: $DATASET, embedder: $EMBED)"
if [ "$EMBED" = "inception" ]; then
    missing=()
    weights="${INCEPTION_WEIGHTS:-third_party/fid/pt_inception-2015-12-05-6726825d.pth}"
    [ -f "$weights" ] || missing+=("$weights (the Inception FID weights, pytorch-fid's pt_inception-2015-12-05-6726825d.pth; or set INCEPTION_WEIGHTS)")
    case "$DATASET" in
        cifar10|cifar10_*) want=("cifar-10-batches-py" "cifar-10-python.tar.gz") ;;
        cifar100|cifar100_*) want=("cifar-100-python" "cifar-100-python.tar.gz") ;;
        afhq_*) want=("afhq/${DATASET#afhq_}/train") ;;
        celeba128) want=("CelebAMask-HQ/CelebA-128-split/test") ;;
        *) want=() ;;
    esac
    if [ "${#want[@]}" -gt 0 ]; then
        found=0
        for w in "${want[@]}"; do [ -e "$DATA_DIR/$w" ] && found=1; done
        [ "$found" = 1 ] || missing+=("$DATA_DIR/${want[0]} (dataset $DATASET under DATA_DIR)")
    fi
    if [ "${#missing[@]}" -gt 0 ]; then
        echo "missing files (nothing is downloaded; place them and rerun):"
        printf '  %s\n' "${missing[@]}"
        exit 1
    fi
fi

echo "== [2/5] FID reference stats ($DATASET reference split)"
python -m contrad_tpu_torch.tools.precalc_stats --dataset "$DATASET" \
    --embed "$EMBED" --device "$DEVICE"

echo "== [3/5] flagship training: sndcgan + contrad + simclr, b512, $STEPS steps"
# shellcheck disable=SC2086  # EXTRA_FLAGS and EXTRA_OVERRIDES split into words
python -m contrad_tpu_torch.train_gan configs/gan/cifar10/c10_b512.toml sndcgan \
    --mode contrad --aug simclr --use_warmup \
    --fid_embed "$EMBED" --evaluate_every "$EVAL_EVERY" \
    --logdir_root "$LOGROOT" --device "$DEVICE" \
    $EXTRA_FLAGS \
    --override options.dataset="$DATASET" options.max_steps="$STEPS" \
               options.fid_size="$FID_SIZE" $EXTRA_OVERRIDES

echo "== [4/5] FID trajectory"
# the most recently written CSV is this run's (logdir suffixes are random)
CSV=$(find "$LOGROOT" -name 'results_fid_*.csv' -printf '%T@ %p\n' | sort -g | tail -1 | cut -d' ' -f2-)
if [ -z "$CSV" ]; then echo "no FID CSV found under $LOGROOT"; exit 1; fi
echo "--- $CSV"
cat "$CSV"
BEST=$(tail -n +2 "$CSV" | awk -F, '{print $NF}' | sort -g | head -1)
echo "BEST FID@${FID_SIZE} ($EMBED embedder): $BEST"

# The final number scored again from PNGs of the best checkpoint by both
# Inception embedders (the one with and the one without the antialiased
# resize). Real weights only. CROSSCHECK=0 skips it.
if [ "$EMBED" = "inception" ] && [ "${CROSSCHECK:-1}" = "1" ]; then
    echo "== [5/5] cross-check: both FID embedders over ${FID_SIZE} sampled PNGs"
    LOGDIR=$(dirname "$CSV")
    python -m contrad_tpu_torch.test_gan_sample "$LOGDIR" sndcgan --ckpt best \
        --n_samples "$FID_SIZE" --batch_size 500 --device "$DEVICE"
    SAMPLES=$(find "$LOGDIR" -maxdepth 1 -type d -name 'samples_*' \
              -printf '%T@ %p\n' | sort -g | tail -1 | cut -d' ' -f2-)
    STATS="${FID_STATS_DIR:-third_party/fid}/${DATASET}_stats.npz"
    python -m contrad_tpu_torch.test_tf_inception "$SAMPLES" "$STATS" \
        --n_imgs "$FID_SIZE" --device "$DEVICE"
    python -m contrad_tpu_torch.test_tf_inception "$SAMPLES" "$STATS" \
        --n_imgs "$FID_SIZE" --embed torch_inception --device "$DEVICE"
    echo "--- embedder agreement log: $LOGDIR/fid.log"
    cat "$LOGDIR/fid.log"
fi
