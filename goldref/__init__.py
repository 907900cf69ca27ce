"""goldref — the golden oracle for the JAX rebuild of irmen/synthesizer.

Because the mounted reference is a tombstone (see SURVEY.md §0), this package
*defines* the behavioral contract: pure-numpy, host-side implementations of

* the ``audioop``-exact PCM primitives (:mod:`goldref.pcm`), cross-checked
  bit-exactly against the local C ``audioop``;
* the oscillator / envelope / effect math as a fixed-point DDS spec
  (:mod:`goldref.osc`);
* reference-level ``Sample`` op semantics (:mod:`goldref.sample`).

The JAX framework in ``synthesizer_tpu`` is tested against this package:
bit-exact for integer PCM ops, bit-exact for float32-spec ops, and ≤1 LSB at
16-bit for the transcendental oscillator path (BASELINE.json north_star).
"""

from . import pcm  # noqa: F401
from . import sample  # noqa: F401
