"""PyTorch/CUDA port of ``neus2_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module names
(``ops/``, ``models/``, ``engine/``, ``utils/``, ``data/``, ``api/``) and
imports neither JAX nor anything of ``neus2_tpu``.  Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
