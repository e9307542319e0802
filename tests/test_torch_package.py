"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
and its entry points refuse to fall back to the CPU unasked."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vsearch_tpu_torch")


def test_import_with_jax_blocked():
    """Every module of the port imports with ``jax`` made unimportable,
    and none of ``vsearch_tpu`` gets loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import vsearch_tpu_torch\n"
        "for m in pkgutil.walk_packages(vsearch_tpu_torch.__path__, "
        "'vsearch_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from vsearch_tpu_torch.retriever import Retriever\n"
        "bad = [m for m in sys.modules if m == 'vsearch_tpu' "
        "or m.startswith('vsearch_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py"))
    + ["chip_smoke.py"])
def test_no_jax_import_lines(path):
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|vsearch_tpu)\b")
    with open(os.path.join(ROOT, path)) as f:
        bad = [line for line in f if pat.match(line)]
    assert not bad, bad


def test_entry_points_raise_without_cuda():
    """Without ``device="cpu"`` an entry point on a machine without CUDA
    raises instead of carrying on on the host."""
    import torch

    from tests.helpers import make_tokenizer, tiny_bert_config
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    tok = make_tokenizer()
    enc = {"type": "vdr", "max_len": 16, "topk": 8, "shift_vocab_num": 5,
           "vocab_size": tok.vocab_size, "hidden_size": 32,
           "num_hidden_layers": 1, "num_attention_heads": 2,
           "intermediate_size": 64}
    with pytest.raises(RuntimeError, match="CUDA"):
        Retriever(RetrieverConfig(encoder_q=enc, encoder_p=enc,
                                  shared_encoder=True), tokenizer=tok)
    with pytest.raises(RuntimeError, match="CUDA"):
        BoTIndex()
