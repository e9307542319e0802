#!/usr/bin/env bash
# The port's counterpart of scripts/svdr_wiki21m/score_wiki21m.sh: top-k
# retrieval accuracy over the search results (on the host only, as its CLI
# runs). Run from the repo root.
set -euo pipefail
TEXT=${TEXT:-data/corpus/wiki21m.jsonl}
RESULT=${RESULT:-data/results/svdr-beta-wiki21m.json}
QA=${QA:-data/eval/wiki21m/nq-test.qa.csv}
PYTHON=${PYTHON:-python}
"$PYTHON" -m vsearch_tpu_torch.cli.score.eval_wiki21m \
    --result_file="$RESULT" --text_file="$TEXT" --qa_file="$QA"
