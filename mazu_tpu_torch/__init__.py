"""mazu_tpu_torch — the PyTorch/CUDA port of ``mazu_tpu``.

The JAX package ``mazu_tpu`` is the reference; this package mirrors its
module paths so each counterpart is easy to find, and it imports neither
``jax`` nor ``mazu_tpu``.

Conventions:

- Host-side builders are NumPy and produce the same arrays (same layouts,
  byte for byte) as the reference builders.
- Query code is plain functions on torch tensors. u64 words (k-mers,
  occurrence words) travel as int64 bit patterns and u32 table rows as
  int32 bit patterns (see ``_words``), because torch on the CPU lacks
  ``>>``, ``<`` and ``minimum`` for the unsigned types.
- Every function that creates a tensor takes an explicit ``device``; there
  is no default device and no silent CPU fallback. A kernel wrapper takes
  its plain torch version only for CPU tensors.
"""

__version__ = "0.1.0"

# Match types (same encoding as mazu_tpu): 0 == no match, 1 == identity
# (query orientation equals the unitig's), 2 == twin (reverse complement).
MATCH_NONE = 0
MATCH_IDENTITY = 1
MATCH_TWIN = 2

# Occurrence orientations (same encoding as mazu_tpu).
ORIENT_FORWARD = 1
ORIENT_BACKWARD = 0
