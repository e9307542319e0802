"""vsearch-tpu on PyTorch and CUDA: the port of ``vsearch_tpu`` to an
NVIDIA H100.

Same structure and names as the JAX package, module for module. Plain
tensor code is PyTorch; the JAX package's Pallas kernels are CUDA C++
kernels under ``ops/csrc/``, built with ``nvcc`` at first use. Every entry
point takes ``device`` (default ``"cuda"``) and raises when CUDA is
absent unless the caller asked for the CPU.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy top-level exports (keep `import vsearch_tpu_torch` light)
    if name in ("Retriever", "RetrieverConfig"):
        from . import retriever
        return getattr(retriever, name)
    if name in ("BiEncoder", "BiEncoderConfig"):
        from . import biencoder
        return getattr(biencoder, name)
    raise AttributeError(name)
