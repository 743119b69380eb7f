#!/usr/bin/env bash
# Create TSE manifests from Libri2Mix metadata with this package's parser.py.
# Usage: ./create_metadata.sh <libri2mix_meta_dir> <corpus_root> <out_root> [librispeech_meta_dir]
# The LibriSpeech metadata tables default to the ones bundled with the repo
# under egs/tse/local/librispeech_metadata/ (data files; the reference
# bundles the same tables); pass a 4th argument to use regenerated ones
# (make_librispeech_metadata.py).
set -euo pipefail

SCRIPT_DIR="$(cd "$(dirname "$0")" && pwd)"

LIBRI2MIX_META=${1:?libri2mix metadata dir}
CORPUS_ROOT=${2:?corpus root}
OUT_ROOT=${3:?output root}
LIBRISPEECH_META=${4:-$SCRIPT_DIR/../../../../egs/tse/local/librispeech_metadata}

declare -A SETS=(
  [train]="mixture_train-100_mix_clean.csv train-clean-100"
  [dev]="mixture_dev_mix_clean.csv dev-clean"
  [eval]="mixture_test_mix_clean.csv test-clean"
)

for split in train dev eval; do
  read -r MIX_CSV LS_CSV <<< "${SETS[$split]}"
  python3 "$SCRIPT_DIR/parser.py" \
    "$LIBRI2MIX_META/$MIX_CSV" \
    "$OUT_ROOT/$split" \
    "$LIBRISPEECH_META/$LS_CSV" \
    "$CORPUS_ROOT"
  echo "wrote manifests: $OUT_ROOT/$split"
done
