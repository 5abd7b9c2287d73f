"""PyTorch + CUDA port of the fleet serving path of ``fluidframework_tpu``.

The JAX package beside this one is the reference; this package mirrors its
subpaths (``ops/``, ``parallel/``, ``service/``, ...) so each module's
counterpart is easy to find. It imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing of ``fluidframework_tpu``.

Entry points take ``device=`` and default to ``"cuda"``; the CPU path
(``device="cpu"``) exists for the tests, where every kernel wrapper runs
its plain PyTorch version.
"""
