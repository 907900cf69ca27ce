"""GUI view smoke tests.

The Tk views are driven BEHAVIORALLY under the fake-Tk harness in
test_gui_behavior.py (key presses reach the mixer, knobs drive the
controller, preset dialogs round-trip) — that suite superseded this
file's old source-string matching.  What remains
here: the views import, and with a real display available (not this
machine: tkinter present, no X server) they construct and tick.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _display_available() -> bool:
    try:
        import tkinter
        root = tkinter.Tk()
        root.destroy()
        return True
    except Exception:
        return False


HAS_DISPLAY = _display_available()


def test_gui_modules_importable():
    import keyboard_gui as kg
    from jukebox import box
    assert hasattr(kg, "SynthGUI")
    assert hasattr(box, "JukeboxGUI")


@pytest.mark.skipif(not HAS_DISPLAY, reason="no X display on this machine")
def test_synth_gui_constructs_under_display(tmp_path):
    import keyboard_gui as kg
    gui = kg.SynthGUI()
    try:
        gui.root.update()
        gui.ctrl.key_down(49)
        gui.root.update()
        gui.ctrl.key_up(49)
        gui.root.update()
    finally:
        gui.output.close()
        gui.root.destroy()


@pytest.mark.skipif(not HAS_DISPLAY, reason="no X display on this machine")
def test_jukebox_gui_constructs_under_display(tmp_path):
    from jukebox import box
    from jukebox.backend import MusicLibrary
    lib = MusicLibrary(str(tmp_path / "lib.sqlite"))
    gui = box.JukeboxGUI(lib)
    try:
        gui.root.update()
    finally:
        gui.root.destroy()
