"""Behavioral GUI driving under the fake-Tk harness.

The views construct for real and their callbacks EXECUTE — key presses
reach the mixer, knob drags reach the controller state, the reverb toggle
installs the master FxChain, preset dialogs round-trip through real files
— instead of being string-matched.  No X server needed.
"""

import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fake_tk  # noqa: E402


@pytest.fixture
def faketk():
    mods = fake_tk.install()
    # the views import tkinter lazily in __init__, but drop any cached
    # real-tkinter modules so the patch is what they see
    try:
        yield mods
    finally:
        fake_tk.uninstall()


def _make_synth_gui():
    import keyboard_gui as kg
    return kg, kg.SynthGUI()


def test_synth_gui_key_press_reaches_mixer(faketk):
    kg, gui = _make_synth_gui()
    try:
        # deliver a real key event through the view's binding
        ch = kg.KEYBOARD_KEYS[0]
        gui.root.event("<KeyPress>", char=ch)
        assert gui.output.mixer.active_count > 0, \
            "key press did not start a mixer voice"
        assert kg.FIRST_KEY in gui.ctrl._active
        gui.root.event("<KeyRelease>", char=ch)
        deadline = time.time() + 10.0
        while gui.output.mixer.active_count and time.time() < deadline:
            time.sleep(0.02)
        assert gui.output.mixer.active_count == 0
        # a key outside the mapping is ignored, not an error
        gui.root.event("<KeyPress>", char="\t")
    finally:
        gui.output.close()
        gui.root.destroy()


def test_synth_gui_knobs_drive_controller(faketk):
    _tk, gui = _make_synth_gui()
    try:
        # oscillator 0 amplitude scale
        osc0 = fake_tk.find_all(fake_tk.LabelFrame, text="osc 0")[0]
        amp_scale = [w for w in osc0.children
                     if isinstance(w, fake_tk.Scale)
                     and w.kw.get("label") == "amp"][0]
        amp_scale.drive(0.77)
        assert gui.ctrl.oscs[0].amplitude == pytest.approx(0.77)
        # waveform combobox routes through the StringVar trace
        gui.wave_vars[0].set("triangle")
        assert gui.ctrl.oscs[0].waveform == "triangle"
        # ADSR scales write the envelope settings
        env = fake_tk.find(fake_tk.LabelFrame, text="ADSR")
        for w in env.children:
            if isinstance(w, fake_tk.Scale) and w.kw.get("label") == "attack":
                w.drive(0.25)
        assert gui.ctrl.env.attack == pytest.approx(0.25)
        # filter enable + cutoff
        filt = fake_tk.find(fake_tk.LabelFrame, text="filter")
        for w in filt.children:
            if isinstance(w, fake_tk.Checkbutton):
                w.invoke()
        assert gui.ctrl.filter.enabled is True
        for w in filt.children:
            if isinstance(w, fake_tk.Scale) and w.kw.get("label") == "cutoff":
                w.drive(2500)
        assert gui.ctrl.filter.cutoff == pytest.approx(2500.0)
    finally:
        gui.output.close()
        gui.root.destroy()


def test_synth_gui_reverb_toggle_installs_fx(faketk):
    _tk, gui = _make_synth_gui()
    try:
        rev = fake_tk.find(fake_tk.LabelFrame, text="reverb")
        toggle = [w for w in rev.children
                  if isinstance(w, fake_tk.Checkbutton)][0]
        toggle.invoke()
        assert gui.ctrl.reverb.enabled is True
        assert gui.output.fx is not None
        assert gui.output.fx_lookahead == 4     # the fx-bus superblock
        for w in rev.children:
            if isinstance(w, fake_tk.Scale) and w.kw.get("label") == "wet":
                w.drive(0.9)
        assert gui.ctrl.reverb.wet == pytest.approx(0.9)
        toggle.invoke()
        assert gui.output.fx is None
    finally:
        gui.output.close()
        gui.root.destroy()


def test_synth_gui_preset_dialog_roundtrip(faketk, tmp_path):
    _tk_mods = faketk
    fd = _tk_mods[2]
    _tk, gui = _make_synth_gui()
    try:
        gui.ctrl.oscs[0].waveform = "square"
        gui.ctrl.oscs[0].amplitude = 0.42
        preset = str(tmp_path / "patch.ini")
        fd.queue.append(preset)
        fake_tk.find(fake_tk.Button, text="save preset").invoke()
        gui.ctrl.oscs[0].waveform = "sine"
        gui.ctrl.oscs[0].amplitude = 0.1
        fd.queue.append(preset)
        fake_tk.find(fake_tk.Button, text="load preset").invoke()
        assert gui.ctrl.oscs[0].waveform == "square"
        assert gui.ctrl.oscs[0].amplitude == pytest.approx(0.42)
        # the view resyncs its waveform vars after a load
        assert gui.wave_vars[0].get() == "square"
        # a cancelled dialog (empty path) is a no-op
        fd.queue.append("")
        fake_tk.find(fake_tk.Button, text="load preset").invoke()
        assert gui.ctrl.oscs[0].waveform == "square"
    finally:
        gui.output.close()
        gui.root.destroy()


def test_jukebox_gui_buttons_drive_engine(faketk, tmp_path):
    import wave as wavemod

    from jukebox import box
    from jukebox.backend import MusicLibrary

    # a real track on disk so enqueue/play have something to chew
    t = np.arange(int(0.3 * 22050))
    tone = (np.sin(2 * np.pi * 330 * t / 22050) * 12000).astype(np.int16)
    wav = tmp_path / "song.wav"
    with wavemod.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(tone.tobytes())
    lib = MusicLibrary(str(tmp_path / "lib.sqlite"))
    lib.scan(str(tmp_path))

    gui = box.JukeboxGUI(lib)
    try:
        assert len(gui.listbox.entries) == 1
        gui.listbox.select(0)
        fake_tk.find(fake_tk.Button, text="enqueue").invoke()
        assert len(gui.box.playlist) == 1
        # pause/resume route into the engine
        fake_tk.find(fake_tk.Button, text="pause").invoke()
        assert gui.box.paused
        fake_tk.find(fake_tk.Button, text="resume").invoke()
        assert not gui.box.paused
        # play spins the engine thread; the track drains from the queue
        fake_tk.find(fake_tk.Button, text="play").invoke()
        deadline = time.time() + 30.0
        while gui.box.playlist and time.time() < deadline:
            time.sleep(0.05)
        assert not gui.box.playlist, "queued track was never consumed"
        fake_tk.find(fake_tk.Button, text="skip").invoke()
        if gui._thread is not None:
            gui._thread.join(timeout=20.0)
    finally:
        gui.root.destroy()


def test_synth_gui_limiter_toggle_installs_fx(faketk):
    _tk, gui = _make_synth_gui()
    try:
        lim = fake_tk.find(fake_tk.LabelFrame, text="limiter")
        toggle = [w for w in lim.children
                  if isinstance(w, fake_tk.Checkbutton)][0]
        toggle.invoke()
        assert gui.ctrl.limiter.enabled is True
        assert gui.output.fx is not None
        for w in lim.children:
            if isinstance(w, fake_tk.Scale) \
                    and w.kw.get("label") == "ceiling dB":
                w.drive(-12.0)
        assert gui.ctrl.limiter.ceiling_db == pytest.approx(-12.0)
        toggle.invoke()
        assert gui.output.fx is None
    finally:
        gui.output.close()
        gui.root.destroy()
