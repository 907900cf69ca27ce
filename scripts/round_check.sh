#!/bin/bash
# End-to-end gate: the test suite and the CLI/server surfaces on the CPU,
# then the on-card smoke run (needs a GPU; exits non-zero without one).
# Usage: ./scripts/round_check.sh
set -e
cd "$(dirname "$0")/.."
CPU="env JAX_PLATFORMS=cpu"
OUT="$(mktemp -d)"
trap 'rm -rf "$OUT"' EXIT

echo "=== 1/6 test suite ==="
python -m pytest tests/ -q -p no:cacheprovider | tail -1

echo "=== 2/6 graft entry + multi-device dryrun (fresh process) ==="
XLA_FLAGS="--xla_force_host_platform_device_count=8" python -c "
import sys; sys.path.insert(0, '.')
import jax; jax.config.update('jax_platforms', 'cpu')
import __graft_entry__ as g
fn, args = g.entry()
print('entry:', jax.jit(fn)(*args).shape)
g.dryrun_multichip(8)"

echo "=== 3/6 demo song via trackmixer CLI ==="
$CPU python examples/make_demo_song.py "$OUT" > /dev/null
$CPU python trackmixer.py "$OUT/demo.ini" -o "$OUT/mix.wav" | tail -1

echo "=== 4/6 MIDI render via trackmixer CLI ==="
$CPU python - "$OUT" <<'PY'
import sys; sys.path.insert(0, '.')
from synthesizer_tpu.midi import MidiNote, write_midi
notes = [MidiNote(i*0.15, 0.12, 57+i*3, 100, 0) for i in range(6)]
open(sys.argv[1] + '/t.mid', 'wb').write(write_midi(notes))
PY
$CPU python trackmixer.py "$OUT/t.mid" -o "$OUT/t.wav" | tail -1

echo "=== 5/6 render server over a real socket ==="
$CPU python - <<'PY'
import sys, json, http.client
sys.path.insert(0, '.')
from synthesizer_tpu.server import RenderServer
srv = RenderServer(port=0).start()
conn = http.client.HTTPConnection('127.0.0.1', srv.port, timeout=120)
conn.request('GET', '/health'); print(conn.getresponse().read().decode())
body = json.dumps({"duration": 0.2, "patch": {"node": "osc", "kind": "sine", "frequency": 440}})
conn.request('POST', '/render/patch', body=body)
r = conn.getresponse(); data = r.read()
assert r.status == 200 and data[:4] == b'RIFF', (r.status, data[:16])
print(f'patch render: {len(data)} WAV bytes')
srv.stop()
PY

echo "=== 6/6 on-card smoke run (GPU) ==="
python chip_smoke.py

echo "=== round check: ALL OK ==="
