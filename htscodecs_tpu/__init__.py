"""htscodecs_tpu — batched CRAM entropy-codec engine in JAX.

A from-scratch JAX/Pallas rebuild of the htscodecs codec family
(reference: jkbonfield/htscodecs v1.1) producing bitstream-identical
output:

- ``rans4x16``: static rANS, 16-bit renorm, 4 interleaved states,
  with PACK / RLE / CAT / NOSZ / N-way STRIPE transforms (CRAM 3.1).
- ``rans4x8``: static rANS, 8-bit renorm (CRAM 3.0).
- ``arith``: adaptive arithmetic (range) coder with order-0/1 byte
  models and RLE variants (CRAM 3.1).
- ``fqz``: fqzcomp quality-score compressor (CRAM 3.1).
- ``tok3``: read-name tokeniser (CRAM 3.1).

Architecture: host-side framing and table construction in C/NumPy,
hot entropy loops in native host kernels for single-block work and in
batched device engines (the GPU kernel of ops/rans_gpu.py, the XLA
scans of ops/rans_v2.py, ops/rans8_v2.py, ops/arith_jax.py) for
throughput across thousands of
independent blocks, grouped by ``models.batch`` and sharded over
device meshes via ``htscodecs_tpu.parallel``.
"""

from . import utils  # noqa: F401
from .models import arith, fqz, rans4x8, rans4x16, tok3  # noqa: F401

__version__ = "0.1.0"


def version() -> str:
    return __version__
