"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
and its entry points refuse to fall back to the CPU unasked."""
import ast
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
        "sys.modules['optax'] = None\n"
        "sys.modules['orbax'] = None\n"
        "import vsearch_tpu_torch\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(vsearch_tpu_torch.__path__, "
        "'vsearch_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        "need = {'vsearch_tpu_torch.cli.serve', "
        "'vsearch_tpu_torch.cli.build_index.sparse_index', "
        "'vsearch_tpu_torch.cli.search.beta_search', "
        "'vsearch_tpu_torch.utils.profiling', 'vsearch_tpu_torch.serve',\n"
        " 'vsearch_tpu_torch.models.dpr', 'vsearch_tpu_torch.models.valid_vocab',\n"
        " 'vsearch_tpu_torch.models.crossmodal_text',\n"
        " 'vsearch_tpu_torch.models.crossmodal_image',\n"
        " 'vsearch_tpu_torch.models.clip_resnet',\n"
        " 'vsearch_tpu_torch.eval.qa_utils',\n"
        " 'vsearch_tpu_torch.eval.retrieval_eval',\n"
        " 'vsearch_tpu_torch.cli.score.eval_wiki21m',\n"
        " 'vsearch_tpu_torch.cli.score.eval_beir',\n"
        " 'vsearch_tpu_torch.config', 'vsearch_tpu_torch.data.dataset',\n"
        " 'vsearch_tpu_torch.data.batching',\n"
        " 'vsearch_tpu_torch.data.iterators',\n"
        " 'vsearch_tpu_torch.data.rag_dataset',\n"
        " 'vsearch_tpu_torch.train.loss', 'vsearch_tpu_torch.train.optim',\n"
        " 'vsearch_tpu_torch.train.step',\n"
        " 'vsearch_tpu_torch.train.checkpoint',\n"
        " 'vsearch_tpu_torch.train.info_card',\n"
        " 'vsearch_tpu_torch.train.trainer', 'vsearch_tpu_torch.cli.train',\n"
        " 'vsearch_tpu_torch.utils.neg_utils',\n"
        " 'vsearch_tpu_torch.parallel', 'vsearch_tpu_torch.parallel.mesh',\n"
        " 'vsearch_tpu_torch.parallel.collectives',\n"
        " 'vsearch_tpu_torch.parallel.sharded_search',\n"
        " 'vsearch_tpu_torch.index.index_utils',\n"
        " 'vsearch_tpu_torch.utils.vis',\n"
        " 'vsearch_tpu_torch.examples.synthetic_vocab',\n"
        " 'vsearch_tpu_torch.examples.quick_start',\n"
        " 'vsearch_tpu_torch.examples.train_demo',\n"
        " 'vsearch_tpu_torch.bench',\n"
        " 'vsearch_tpu_torch.ops.probes'} | {\n"
        " 'vsearch_tpu_torch.scripts.' + p for p in (\n"
        " 'probe_bitcast_layout', 'probe_pack', 'probe_scorer_variants',\n"
        " 'probe_int8_scorer', 'probe_block_parts', 'probe_block_b2048',\n"
        " 'bitpack_regret_probe', 'probe_alpha_sweep', 'probe_stream',\n"
        " 'probe_embed_mfu', 'probe_serve_server', 'probe_serve_load')}\n"
        "assert need <= names, need - names\n"
        "from vsearch_tpu_torch.retriever import Retriever\n"
        "assert Retriever.retireve_negatives is Retriever.retrieve_negatives\n"
        "from vsearch_tpu_torch.ops.sparse import build_cts_mask, "
        "init_cts_mask_like\n"
        "from vsearch_tpu_torch.models.registry import get_encoder_classes\n"
        "for t in ('dpr', 'vdr_crossmodal_text', 'vdr_crossmodal_image'):\n"
        "    get_encoder_classes(t)\n"
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
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|vsearch_tpu)\b")
    with open(os.path.join(ROOT, path)) as f:
        bad = [line for line in f if pat.match(line)]
    assert not bad, bad


def test_entry_points_raise_without_cuda():
    """Without ``device="cpu"`` an entry point on a machine without CUDA
    raises instead of carrying on on the host."""
    import torch

    import numpy as np

    from tests.helpers import make_tokenizer, tiny_bert_config
    from vsearch_tpu_torch.index import BoTIndex
    from vsearch_tpu_torch.index.streamed import StreamedBitpackSearcher
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
    with pytest.raises(RuntimeError, match="CUDA"):
        BoTIndex(search_mode="block")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamedBitpackSearcher(np.zeros((4, 8), np.int32),
                                np.ones(4, np.int32), 300)


def test_bench_refuses_without_cuda():
    """``python -m vsearch_tpu_torch.bench`` (``--device cuda`` by
    default) on a machine without CUDA prints ``bench.py``'s
    ``bench_error`` line and exits 2."""
    import json

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    out = subprocess.run([sys.executable, "-m", "vsearch_tpu_torch.bench",
                          "--num-passages", "16"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2, out.stderr
    line = json.loads(out.stdout)
    assert line["metric"] == "bench_error" and line["value"] == 0.0


def test_every_kernel_has_a_counter_and_a_plain_twin():
    """Each source in ``cuda_build.SOURCES`` is launched by exactly one
    wrapper in ``ops/bitpack.py`` or ``ops/probes.py`` (``_launch("name",
    ...)``, or ``_plane_keys("name", ...)``, the launcher that kernel #3's
    plane form shares with its timing variants; ``probes.plane_variant``
    launches each of ``probes.PLANE_VARIANTS``), has a counter in
    ``LAUNCHES``, and its wrapper ``f`` runs ``f_plain``, a function of
    the same module: a kernel cannot land without its twin."""
    from vsearch_tpu_torch.ops import bitpack, cuda_build, probes

    launchers = ("_launch", "_plane_keys")
    launched = {}
    for mod in (bitpack, probes):
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef) or fn.name == "_plane_keys":
                continue
            calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)]
            names = {c.func.id for c in calls if isinstance(c.func, ast.Name)}
            for c in calls:
                if not (isinstance(c.func, ast.Name) and c.func.id in launchers
                        or isinstance(c.func, ast.Attribute)
                        and c.func.attr in launchers):
                    continue
                arg = c.args[0]
                if isinstance(arg, ast.Constant):
                    kernels = [arg.value]
                else:
                    assert fn.name == "plane_variant", fn.name
                    kernels = list(probes.PLANE_VARIANTS)
                for k in kernels:
                    assert k not in launched, k
                    launched[k] = fn.name
                assert f"{fn.name}_plain" in names, fn.name
                assert callable(getattr(mod, f"{fn.name}_plain"))
    assert set(launched) == set(cuda_build.SOURCES) == \
        set(bitpack.LAUNCHES), launched


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from tests.helpers import make_tokenizer
    from vsearch_tpu_torch.retriever import Retriever, RetrieverConfig

    tok = make_tokenizer()
    enc = {"type": "vdr", "max_len": 16, "topk": 8, "shift_vocab_num": 5,
           "vocab_size": tok.vocab_size, "hidden_size": 32,
           "num_hidden_layers": 1, "num_attention_heads": 2,
           "intermediate_size": 64}
    d = tmp_path_factory.mktemp("ckpt")
    Retriever(RetrieverConfig(encoder_q=enc, encoder_p=enc,
                              shared_encoder=True), tokenizer=tok,
              device="cpu").save_pretrained(str(d / "ckpt"))
    (d / "corpus.jsonl").write_text('{"text": "green tea"}\n')
    (d / "q.jsonl").write_text('{"question": "tea"}\n')
    return d


@pytest.mark.parametrize("entry", [
    "from_pretrained", "serve_cli", "binary_token_index", "sparse_index",
    "dense_index", "search_sparse_index", "search_dense_index",
    "beta_search", "convert_checkpoint", "trace", "device_memory_stats",
    "eval_beir", "dpr", "crossmodal_text", "crossmodal_image", "train",
    "quick_start", "train_demo", "build_bot_ell", *(
        "scripts." + p for p in (
            "probe_bitcast_layout", "probe_pack", "probe_scorer_variants",
            "probe_int8_scorer", "probe_block_parts", "probe_block_b2048",
            "bitpack_regret_probe", "probe_alpha_sweep", "probe_stream",
            "probe_embed_mfu", "probe_serve_server", "probe_serve_load"))])
def test_new_entry_points_raise_without_cuda(checkpoint, entry):
    """The checkpoint loader, every CLI of ``cli/`` (no ``--device``), the
    encoders, the device readers of ``utils/``, the tools of
    ``examples/``, the probes of ``scripts/`` and the bag-of-token build
    raise without CUDA."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    d = checkpoint
    ck = ["--checkpoint", str(d / "ckpt")]
    out = str(d / "out.npz")
    argv = {
        "binary_token_index": ["--text_file", str(d / "corpus.jsonl"),
                               "--save_file", out, "--num_shift", "5",
                               "--tokenizer", str(d / "ckpt")],
        "sparse_index": ck + ["--text_file", str(d / "corpus.jsonl"),
                              "--save_file", out],
        "search_sparse_index": ck + ["--query_file", str(d / "q.jsonl"),
                                     "--index_file", out,
                                     "--save_file", out],
        "beta_search": ck + ["--query_file", str(d / "q.jsonl"),
                             "--text_file", str(d / "corpus.jsonl"),
                             "--index_file", out, "--save_file", out],
        "convert_checkpoint": ["--torch_dir", str(d / "ckpt"),
                               "--out", str(d / "conv")],
        "eval_beir": ck + ["--corpus_file", str(d / "corpus.jsonl"),
                           "--query_file", str(d / "q.jsonl"),
                           "--qrels_file", str(d / "q.jsonl")],
    }
    argv["dense_index"] = argv["sparse_index"]
    argv["search_dense_index"] = argv["search_sparse_index"]
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "from_pretrained":
            from vsearch_tpu_torch.retriever import Retriever
            Retriever.from_pretrained(str(d / "ckpt"))
        elif entry == "serve_cli":
            from vsearch_tpu_torch.cli.serve import (make_parser,
                                                     prepare_retriever)
            ap = make_parser()
            prepare_retriever(ap.parse_args(ck), ap)
        elif entry in ("dpr", "crossmodal_text", "crossmodal_image"):
            from tests.helpers import make_tokenizer
            from vsearch_tpu_torch.models.registry import get_encoder_classes

            cfg_cls, enc_cls = get_encoder_classes(
                "dpr" if entry == "dpr" else f"vdr_{entry}")
            enc_cls(cfg_cls.from_dict({"num_hidden_layers": 1, "layers": 1,
                                       "vocab_size": 64, "hidden_size": 32,
                                       "num_attention_heads": 2,
                                       "intermediate_size": 64, "width": 32,
                                       "heads": 2}),
                    tokenizer=make_tokenizer())
        elif entry == "train":
            from vsearch_tpu_torch.cli import train
            train.main(["--config", os.path.join(ROOT, "conf",
                                                 "train_ir_cfg.yaml"),
                        f"model_path={d / 'ckpt'}",
                        f"output_dir={d / 'train_out'}"])
        elif entry == "trace":
            from vsearch_tpu_torch.utils.profiling import trace
            with trace(str(d / "trace")):
                pass
        elif entry == "quick_start":
            from vsearch_tpu_torch.examples import quick_start
            quick_start.main([])
        elif entry == "train_demo":
            from vsearch_tpu_torch.examples import train_demo
            train_demo.main(["--num-topics", "4"])
        elif entry.startswith("scripts."):
            importlib.import_module(f"vsearch_tpu_torch.{entry}").main([])
        elif entry == "build_bot_ell":
            from tests.helpers import make_tokenizer
            from vsearch_tpu_torch.index.bot_build import build_bot_ell
            build_bot_ell(make_tokenizer(), ["green tea"], 16, 5)
        elif entry == "device_memory_stats":
            from vsearch_tpu_torch.utils.profiling import \
                device_memory_stats
            device_memory_stats()
        else:
            pkg = ("vsearch_tpu_torch.cli" if entry == "convert_checkpoint"
                   else "vsearch_tpu_torch.cli.score" if entry == "eval_beir"
                   else "vsearch_tpu_torch.cli.build_index"
                   if entry.endswith("_index") and "search" not in entry
                   else "vsearch_tpu_torch.cli.search")
            importlib.import_module(f"{pkg}.{entry}").main(argv[entry])
