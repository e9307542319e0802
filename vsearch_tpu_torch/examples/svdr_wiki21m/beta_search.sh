#!/usr/bin/env bash
# The port's counterpart of scripts/svdr_wiki21m/beta_search.sh: semi-
# parametric retrieval over the binary token index with neural rerank, on
# $DEVICE (cuda by default). $QUERY names the query file. Run from the
# repo root.
set -euo pipefail
CKPT=${CKPT:-checkpoints/svdr-nq}
TEXT=${TEXT:-data/corpus/wiki21m.jsonl}
INDEX=${INDEX:-data/index/wiki21m_bow.npz}
SAVE=${SAVE:-data/results/svdr-beta-wiki21m.json}
QUERY=${QUERY:-data/eval/wiki21m/nq-test-questions.jsonl}
DEVICE=${DEVICE:-cuda}
PYTHON=${PYTHON:-python}
"$PYTHON" -m vsearch_tpu_torch.cli.search.beta_search --checkpoint="$CKPT" \
    --query_file="$QUERY" \
    --text_file="$TEXT" --index_file="$INDEX" --save_file="$SAVE" \
    --num_rerank=100 --device="$DEVICE"
