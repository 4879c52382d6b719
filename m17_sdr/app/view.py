"""Status view: the terminal MMI screen.

Reference: gui.cpp (ncurses status page: mode, reflector, TX/RX state,
callsigns, frequencies, signal bar).  Rendered as plain text lines so
it works in any terminal and in logs; `repl --live` wraps it in the
curses loop of app/curses_view.py, which redraws in place with the
reference's color zones.
"""

from __future__ import annotations

from .dbase import Dbase


def bar(value: float, width: int = 40) -> str:
    """Signal/power bar with the reference's color zones rendered as
    characters (gui_bar, gui.cpp:157-190)."""
    value = min(max(value, 0.0), 1.0)
    n = int(value * width)
    return "[" + "#" * n + "-" * (width - n) + f"] {value:4.2f}"


def render(db: Dbase, signal: float = 0.0, extra_lines: list[str] | None = None) -> str:
    """Build the status screen (gui_update, gui.cpp:115-229)."""
    state = "TX" if db.ptt else "RX"
    conn = (f"CONN M17-{db.connected_reflector} {db.reflector_module}"
            if db.connected_reflector else "not connected")
    lines = [
        "== M17 SDR transceiver ==",
        f"mode: {db.chan_type.value:8s}  state: {state}   {conn}",
        f"SRC: {db.tx_src_call:10s} DEST: {db.tx_dest_call:10s}",
        f"RXF: {db.rx_freq/1e6:12.6f} MHz   TXF: {db.tx_freq/1e6:12.6f} MHz"
        f"   AFC: {'on' if db.afc else 'off'}",
        f"frames: {db.n_frames:6d}  golay errs: {db.golay_errors:5d}  "
        f"in_frame: {db.in_frame}",
        bar(signal),
    ]
    if extra_lines:
        lines.extend(extra_lines)
    return "\n".join(lines)
