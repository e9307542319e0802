"""Wordcloud visualization for token-weight dicts (counterpart of
``vsearch_tpu/utils/vis.py``, itself after the reference's
src/ir/utils/vis.py:5-14). Without the optional wordcloud/matplotlib
stack it prints the top tokens instead."""
from __future__ import annotations

import math
from typing import Dict, Optional


def wordcloud_from_dict(d: Dict[str, float], max_words: int = 100,
                        log_scale: bool = False,
                        save_file: Optional[str] = None):
    d = {k: v for k, v in d.items() if v > 0}  # WordCloud needs > 0
    if log_scale:
        d = {k: math.log(1 + v) for k, v in d.items()}
    if not d:
        # all-zero weights (a fully gated embedding): nothing to draw
        return None
    try:
        from wordcloud import WordCloud
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        # no wordcloud/matplotlib: report the top words as text
        top = sorted(d.items(), key=lambda kv: -kv[1])[:max_words]
        summary = ", ".join(f"{k}:{v:.3f}" for k, v in top[:20])
        print(f"[vsearch-tpu] wordcloud unavailable; top tokens: {summary}")
        return None
    wc = WordCloud(width=800, height=400, background_color="white",
                   max_words=max_words).generate_from_frequencies(d)
    plt.figure(figsize=(10, 5))
    plt.imshow(wc, interpolation="bilinear")
    plt.axis("off")
    if save_file:
        plt.savefig(save_file, bbox_inches="tight")
    plt.close()
    return wc
