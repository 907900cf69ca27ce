"""Python 3.13 readiness: the framework must survive audioop's removal.
Runs a representative slice of the suite in a child
pytest with the module hidden: the goldref audioop-conformance tests skip
cleanly (goldref becomes the sole spec) and product tests stay green."""

import os
import subprocess
import sys

def test_suite_green_with_audioop_hidden():
    env = {**os.environ, "SYNTH_TPU_HIDE_AUDIOOP": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "tests/test_goldref_pcm.py",            # must SKIP cleanly
         "tests/test_sample.py",                 # device ops vs goldref
         "tests/test_native_pcmops.py",          # native lib needs no audioop
         ],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=600)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else r.stderr
    assert r.returncode == 0, r.stdout + r.stderr
    assert "skipped" in tail, tail                # goldref conformance skipped
    assert "passed" in tail, tail                 # everything else green
    # and the skip really is the audioop suite, not something else
    assert "error" not in tail
