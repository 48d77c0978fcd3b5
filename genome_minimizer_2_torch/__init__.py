"""genome_minimizer_2_torch — the PyTorch/CUDA port of genome_minimizer_2_tpu.

The JAX package beside it is the reference; this package mirrors its layout
(``core/``, ``ops/``, ``models/``, ``sample/``, ``genome/``, ``parallel/``,
``utils/``, ``data/``, ``pipeline.py``) so each module has an obvious
counterpart, and it never imports ``jax`` or ``genome_minimizer_2_tpu``.

What is ported so far is the streaming pipeline: checkpoint -> decode ->
the hand-written CUDA ``decode_threshold_pack`` kernel (``csrc/``) -> native
minimize (``native/gm2min.cpp``) -> FASTA, driven by
``python -m genome_minimizer_2_torch.cli --mode pipeline``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` on the CLI); asking for CUDA on a host
without a card raises.
"""

__version__ = "0.1.0"
