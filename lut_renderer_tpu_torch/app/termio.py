"""Shared terminal key input for the TUIs (monitor + interactive).

One place for the termios dance and its sharp edges:
- cbreak via TCSADRAIN, NOT setcbreak's default TCSAFLUSH (FLUSH discards
  keys typed before the thread finished starting — real keystrokes lost
  under load, caught by the pty test);
- escape sequences are assembled here so arrow keys arrive as ONE key
  string ("\\x1b[A"), and a lone ESC press is still delivered promptly
  (50 ms select window);
- stdin EOF / a non-tty stdin quits the view instead of spinning forever.
"""

from __future__ import annotations

import select
import sys
import threading
from typing import Callable, Optional


def _read_escape(fd) -> str:
    """After an ESC byte: assemble a CSI sequence if more input is pending
    within 50 ms, else deliver the bare ESC."""
    seq = "\x1b"
    for _ in range(2):
        r, _w, _x = select.select([fd], [], [], 0.05)
        if not r:
            break
        ch = sys.stdin.read(1)
        if not ch:
            break
        seq += ch
        if len(seq) == 2 and ch != "[":
            break                      # ESC + non-CSI: two separate keys
        if len(seq) == 3:
            break                      # ESC [ X — complete arrow/CSI
    return seq


def key_input_loop(on_key: Callable[[str], None],
                   quit_event: threading.Event,
                   input_fn: Optional[Callable[[], str]] = None) -> None:
    """Blocking key loop: reads single keys (escape sequences assembled)
    and feeds them to on_key until quit_event is set or stdin ends.

    input_fn injects keys for tests; EOF ("" return) quits either way."""
    if input_fn is not None:
        while not quit_event.is_set():
            key = input_fn()
            if not key:
                quit_event.set()
                return
            on_key(key)
        return

    import termios
    import tty

    try:
        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
    except (ValueError, OSError, termios.error):
        # non-tty stdin (redirected/closed): nothing to read interactively
        quit_event.set()
        return
    try:
        tty.setcbreak(fd, termios.TCSADRAIN)
        while not quit_event.is_set():
            key = sys.stdin.read(1)
            if not key:                 # EOF: hangup/redirect — quit view
                quit_event.set()
                return
            if key == "\x1b":
                seq = _read_escape(fd)
                if len(seq) == 2:       # ESC + ordinary key: deliver both
                    on_key("\x1b")
                    on_key(seq[1])
                    continue
                key = seq
            on_key(key)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
