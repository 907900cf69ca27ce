"""A headless stand-in for the tkinter API surface the GUI views use.

the GUI smoke tests were string matching.  This module
lets CI CONSTRUCT SynthGUI/JukeboxGUI and RUN their callbacks without an X
server: widgets record their configuration, variables fire their traces,
and buttons/scales/checkbuttons expose ``invoke``/``drive`` so tests
execute the real view code paths (key bindings, knob commands, preset
dialogs) end to end into the tested controllers.

Install with :func:`install` (patches sys.modules for tkinter /
tkinter.ttk / tkinter.filedialog — the views import tkinter lazily inside
__init__, so patching at test time is enough) and restore with
:func:`uninstall`.
"""

from __future__ import annotations

import sys
import types
from typing import Callable, Dict, List, Optional

# geometry constants (values irrelevant — only identity matters)
TOP, BOTTOM, LEFT, RIGHT = "top", "bottom", "left", "right"
X, Y, BOTH, END, HORIZONTAL, VERTICAL = "x", "y", "both", "end", "h", "v"

#: every widget constructed since the last install() — tests search this
WIDGETS: List["Widget"] = []


class _Var:
    _kind = "var"

    def __init__(self, value=None):
        self._value = value
        self._traces: List[Callable] = []

    def get(self):
        return self._value

    def set(self, value):
        self._value = value
        for cb in self._traces:
            cb()

    def trace_add(self, _mode, cb):
        # tkinter passes (name, index, op) — the views ignore them
        self._traces.append(lambda: cb(None, None, None))


class StringVar(_Var):
    def __init__(self, value=""):
        super().__init__(value)


class BooleanVar(_Var):
    def __init__(self, value=False):
        super().__init__(bool(value))


class DoubleVar(_Var):
    def __init__(self, value=0.0):
        super().__init__(float(value))


class IntVar(_Var):
    def __init__(self, value=0):
        super().__init__(int(value))


class Widget:
    def __init__(self, master=None, **kw):
        self.master = master
        self.kw = kw
        self.children: List[Widget] = []
        if master is not None and hasattr(master, "children"):
            master.children.append(self)
        WIDGETS.append(self)

    def pack(self, **_kw):
        return self

    def grid(self, **_kw):
        return self

    def configure(self, **kw):
        self.kw.update(kw)

    config = configure

    def destroy(self):
        pass


class Frame(Widget):
    pass


class LabelFrame(Widget):
    pass


class Label(Widget):
    pass


class Button(Widget):
    def invoke(self):
        cb = self.kw.get("command")
        if cb:
            return cb()


class Checkbutton(Widget):
    def invoke(self):
        var = self.kw.get("variable")
        if var is not None:
            var.set(not var.get())
        cb = self.kw.get("command")
        if cb:
            return cb()


class Combobox(Widget):
    def drive(self, value):
        """Simulate choosing a value: set the textvariable (fires its
        traces) and run the postcommand like a dropdown open would."""
        var = self.kw.get("textvariable")
        if var is not None:
            var.set(value)
        post = self.kw.get("postcommand")
        if post:
            post()


class Scale(Widget):
    def drive(self, value):
        """Simulate dragging: tkinter calls command with the str value."""
        var = self.kw.get("variable")
        if var is not None:
            var.set(value)
        cb = self.kw.get("command")
        if cb:
            cb(str(value))

    set = drive


class Canvas(Widget):
    def __init__(self, master=None, **kw):
        super().__init__(master, **kw)
        self.items: List[tuple] = []

    def create_rectangle(self, *coords, **kw):
        self.items.append(("rectangle", coords, kw))
        return len(self.items)

    def create_text(self, *coords, **kw):
        self.items.append(("text", coords, kw))
        return len(self.items)

    def itemconfig(self, item, **kw):
        kind, coords, old = self.items[item - 1]
        old.update(kw)

    def delete(self, *_a):
        pass


class Listbox(Widget):
    def __init__(self, master=None, **kw):
        super().__init__(master, **kw)
        self.entries: List[str] = []
        self._selection: tuple = ()

    def insert(self, _where, value):
        self.entries.append(value)

    def curselection(self):
        return self._selection

    def select(self, *indices):
        self._selection = tuple(indices)


class Event:
    def __init__(self, char="", keysym=""):
        self.char = char
        self.keysym = keysym or char


class Tk(Widget):
    def __init__(self, **kw):
        super().__init__(None, **kw)
        self._bindings: Dict[str, Callable] = {}
        self._title = ""

    def title(self, t=""):
        self._title = t

    def bind(self, sequence, cb):
        self._bindings[sequence] = cb

    def event(self, sequence, char=""):
        """Deliver a synthetic event to a bound handler."""
        return self._bindings[sequence](Event(char=char))

    def update(self):
        pass

    update_idletasks = update

    def mainloop(self):
        pass

    def after(self, _ms, cb=None, *a):
        if cb:
            cb(*a)

    def protocol(self, *_a, **_k):
        pass


def find(cls, **match) -> Widget:
    """First widget of ``cls`` whose kw contain all of ``match``."""
    for w in WIDGETS:
        if isinstance(w, cls) and all(w.kw.get(k) == v
                                      for k, v in match.items()):
            return w
    raise KeyError(f"no {cls.__name__} with {match}")


def find_all(cls, **match) -> List[Widget]:
    return [w for w in WIDGETS
            if isinstance(w, cls) and all(w.kw.get(k) == v
                                          for k, v in match.items())]


class _FileDialog(types.ModuleType):
    """Scriptable filedialog: queue the paths the next dialogs return."""

    def __init__(self):
        super().__init__("tkinter.filedialog")
        self.queue: List[Optional[str]] = []

    def _next(self):
        return self.queue.pop(0) if self.queue else ""

    def askopenfilename(self, **_kw):
        return self._next()

    def asksaveasfilename(self, **_kw):
        return self._next()


_saved: dict = {}


def install():
    """Patch sys.modules so `import tkinter` yields this fake; returns the
    (tk_module, ttk_module, filedialog_module) triple."""
    WIDGETS.clear()
    tk_mod = types.ModuleType("tkinter")
    for name, obj in globals().items():
        if isinstance(obj, type) or name in (
                "TOP", "BOTTOM", "LEFT", "RIGHT", "X", "Y", "BOTH", "END",
                "HORIZONTAL", "VERTICAL"):
            setattr(tk_mod, name, obj)
    ttk_mod = types.ModuleType("tkinter.ttk")
    for name in ("Frame", "LabelFrame", "Label", "Button", "Checkbutton",
                 "Combobox", "Scale"):
        setattr(ttk_mod, name, globals()[name])
    fd_mod = _FileDialog()
    tk_mod.ttk = ttk_mod
    tk_mod.filedialog = fd_mod
    for key in ("tkinter", "tkinter.ttk", "tkinter.filedialog"):
        _saved[key] = sys.modules.get(key)
    sys.modules["tkinter"] = tk_mod
    sys.modules["tkinter.ttk"] = ttk_mod
    sys.modules["tkinter.filedialog"] = fd_mod
    return tk_mod, ttk_mod, fd_mod


def uninstall():
    for key, mod in _saved.items():
        if mod is None:
            sys.modules.pop(key, None)
        else:
            sys.modules[key] = mod
    _saved.clear()
