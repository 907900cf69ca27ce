"""Device-side DSP ops: XLA PCM primitives, the exact resampler and the
effects rack."""

from . import pcm  # noqa: F401
from . import resample  # noqa: F401
