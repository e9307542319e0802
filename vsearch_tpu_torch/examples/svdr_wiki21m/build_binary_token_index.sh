#!/usr/bin/env bash
# The port's counterpart of scripts/svdr_wiki21m/build_binary_token_index.sh:
# tokenizer-only bag-of-token index build over the wiki21m corpus, on
# $DEVICE (cuda by default; cpu runs it on the host). The tokenizer is
# bert-base-uncased's: point VSEARCH_TPU_VOCAB at its vocab.txt (for example
# a checkpoint's). Run from the repo root.
set -euo pipefail
TEXT=${TEXT:-data/corpus/wiki21m.jsonl}
SAVE=${SAVE:-data/index/wiki21m_bow.npz}
DEVICE=${DEVICE:-cuda}
PYTHON=${PYTHON:-python}
"$PYTHON" -m vsearch_tpu_torch.cli.build_index.binary_token_index \
    --text_file="$TEXT" --save_file="$SAVE" \
    --batch_size=1024 --num_shift=999 --device="$DEVICE"
