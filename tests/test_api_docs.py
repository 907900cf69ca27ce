"""docs/API.md is GENERATED — this test keeps it honest:
it regenerates the reference from the live package and fails when the
checked-in file is stale, and spot-checks completeness (every public
Sample method and every oscillators.__all__ name appears)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
API_MD = os.path.join(ROOT, "docs", "API.md")


def test_api_md_is_current():
    import gen_api_docs
    want = gen_api_docs.generate()
    got = open(API_MD).read()
    assert got == want, (
        "docs/API.md is stale — run `python scripts/gen_api_docs.py`")


def test_api_md_is_complete():
    from synthesizer_tpu import oscillators as O
    from synthesizer_tpu.sample import Sample
    text = open(API_MD).read()
    for n in dir(Sample):
        if not n.startswith("_") and callable(getattr(Sample, n)):
            assert f"`{n}(" in text, f"Sample.{n} missing from API.md"
    for n in O.__all__:
        assert f"`{n}(" in text, f"oscillators.{n} missing from API.md"
    for n in ("FxChain", "StreamingLimiter", "render_midi", "VoiceBank",
              "render_song_sharded", "RenderServer", "UserOscillator"):
        assert n in text, f"{n} missing from API.md"
