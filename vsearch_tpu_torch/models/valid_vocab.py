"""Valid-vocabulary subspace of the cross-modal VDR encoders
(counterpart of ``vsearch_tpu/models/valid_vocab.py``).

The cross-modal encoders project onto the subset of bert-base-uncased's
vocabulary that excludes specials, unused slots, single characters,
non-English fragments and suffix pieces. The exclusion set is model data
that checkpoints depend on, stored as ranges plus scattered ids (2,899
excluded -> 27,623 valid of 30,522).
"""
from __future__ import annotations

import numpy as np

_INVALID_RANGES = [(0, 998), (1067, 1995), (29644, 30521)]
_INVALID_SCATTERED = [
    3186, 6362, 7030, 7737, 8157, 8229, 10260, 10325, 10701, 11622,
    11722, 11871, 12744, 13714, 14150, 14157, 14241, 14498, 14534,
    14608, 15290, 15297, 15394, 15414, 15915, 16177, 16198, 16415,
    16856, 17004, 17110, 17149, 17432, 17499, 17814, 18107, 18199,
    18511, 18728, 18818, 18947, 19109, 19110, 19259, 19310, 19433,
    19579, 19704, 19865, 20190, 21853, 21932, 22192, 22543, 22646,
    22919, 22972, 23305, 23432, 23483, 23673, 23742, 23925, 24102,
    24824, 24830, 24833, 24967, 25160, 25529, 25573, 25799, 26133,
    26306, 26444, 26789, 26812, 27392, 27432, 27688, 27708, 27807,
    27813, 27904, 27944, 28182, 28598, 28995, 29113, 29128, 29155,
    29275, 29436,
]


def invalid_token_ids(vocab_size: int = 30522) -> np.ndarray:
    mask = np.zeros(vocab_size, dtype=bool)
    for lo, hi in _INVALID_RANGES:
        mask[lo: hi + 1] = True
    mask[_INVALID_SCATTERED] = True
    return np.nonzero(mask)[0]


def valid_token_ids(vocab_size: int = 30522) -> np.ndarray:
    mask = np.ones(vocab_size, dtype=bool)
    for lo, hi in _INVALID_RANGES:
        mask[lo: hi + 1] = False
    mask[_INVALID_SCATTERED] = False
    return np.nonzero(mask)[0]


VALID_TOKEN_IDS = valid_token_ids()
# valid-space id <-> LM vocab id maps (reference naming)
VID2LID = {vid: int(lid) for vid, lid in enumerate(VALID_TOKEN_IDS)}
LID2VID = {lid: vid for vid, lid in VID2LID.items()}
