"""Audio input/output streams for the streaming pipeline (the port's copy
of thewhisper_tpu's ``streaming/streams.py``).

Parity with reference ``streaming/streams.py``:

- ``ArrayStream``: real-time pacing — if the caller lagged, return an
  ``elapsed + step`` sized chunk, else sleep out the remainder and return a
  step-sized chunk (``streams.py:53-70``).
- ``FileStream``: WAV loading via our own loader (reference uses librosa).
- ``MicStream``: sounddevice capture on a reader thread; gated because
  sounddevice is absent in many deployments.
- ``StdoutStream``: ANSI in-place rewrite of committed (stable) and
  assumption (mutable) text (``streams.py:173-224``).
"""

from __future__ import annotations

import re
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from thewhisper_tpu_torch.audio.io import load_audio


class ArrayStream:
    """Stream float32 mono chunks out of an in-memory array."""

    def __init__(
        self,
        audio_data: np.ndarray,
        step_size_s: float = 0.5,
        sample_rate: int = 16000,
        real_time: bool = True,
    ):
        self.audio_data = np.asarray(audio_data, dtype=np.float32).reshape(-1)
        self.sample_rate = sample_rate
        self.step_size_s = step_size_s
        self.real_time = real_time
        self._pos = 0
        self._last_t: Optional[float] = None
        self._eof = False

    def next_chunk(self) -> Optional[np.ndarray]:
        if self._eof:
            return None
        step = int(self.step_size_s * self.sample_rate)
        if self.real_time:
            now = time.time()
            if self._last_t is not None:
                elapsed = now - self._last_t
                if elapsed > self.step_size_s:
                    # Caller lagged: catch up with a bigger chunk.
                    step = int((elapsed + self.step_size_s) * self.sample_rate)
                else:
                    time.sleep(self.step_size_s - elapsed)
            self._last_t = time.time()
        chunk = self.audio_data[self._pos: self._pos + step]
        self._pos += step
        if self._pos >= len(self.audio_data):
            self._eof = True
        return chunk.astype(np.float32, copy=False)

    def close(self) -> None:
        self._pos = 0
        self._last_t = None
        self._eof = False
        self.audio_data = None


class FileStream(ArrayStream):
    """Stream a WAV file (any rate/layout; resampled to ``sample_rate``)."""

    def __init__(
        self,
        path: str,
        step_size_s: float = 0.5,
        sample_rate: int = 16000,
        real_time: bool = True,
    ):
        self.path = path
        audio = load_audio(path, sr=sample_rate)
        super().__init__(audio, step_size_s, sample_rate, real_time)


class MicStream:
    """Real-time microphone stream (requires the sounddevice package)."""

    def __init__(
        self,
        step_size_s: float = 0.5,
        sample_rate: int = 16000,
        device: Optional[int] = None,
        channels: int = 1,
    ):
        try:
            from sounddevice import InputStream
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "MicStream requires the 'sounddevice' package, which is not "
                "installed; use FileStream/ArrayStream instead") from e
        self.step_size_s = step_size_s
        self.sample_rate = sample_rate
        self.stream = InputStream(
            samplerate=sample_rate,
            blocksize=int(step_size_s * sample_rate / 2),
            device=device,
            channels=channels,
        )
        self._queue: List[np.ndarray] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._reader, daemon=True)

    def _reader(self) -> None:  # pragma: no cover - needs hardware
        self.stream.start()
        frames = int(self.step_size_s * self.sample_rate)
        while not self._stop.is_set():
            chunk, _ = self.stream.read(frames)
            with self._lock:
                self._queue.append(np.asarray(chunk).squeeze())

    def next_chunk(self) -> Optional[np.ndarray]:  # pragma: no cover
        if not self._thread.is_alive():
            self._thread.start()
        while True:
            with self._lock:
                if self._queue:
                    out = np.concatenate(self._queue, axis=0)
                    self._queue = []
                    return out
            time.sleep(0.01)

    def close(self) -> None:  # pragma: no cover
        self._stop.set()
        self.stream.stop()
        self.stream.close()


class StdoutStream:
    """Render committed text in place and rewrite the assumption tail.

    Implementation: the whole display line (committed prefix + mutable
    assumption tail) is re-rendered as one string every call and diffed
    once against what is currently on screen — the cursor backs up over
    the divergent tail, clears to end of line, and writes the new suffix.
    Committed text only ever grows, so in practice the repaint touches
    just the assumption region.
    """

    def __init__(self, file=None):
        self._out = file or sys.stdout
        self._show_cursor = "\x1b[?25h"
        self._clear_eol = "\x1b[K"
        self._all_committed: List[str] = []
        self._on_screen = ""
        self._out.write("\x1b[?25l")            # hide cursor while live

    _ANSI = re.compile(r"\x1b\[[0-9;]*[A-Za-z]")

    @classmethod
    def _visible_len(cls, s: str) -> int:
        """Terminal columns occupied: ANSI escapes take zero, East-Asian
        wide/fullwidth glyphs (CJK transcripts) take two — a flat
        one-column assumption under-counted backspaces and walked the
        cursor into committed text, the failure the ANSI fix targets."""
        import unicodedata

        return sum(2 if unicodedata.east_asian_width(ch) in ("W", "F") else 1
                   for ch in cls._ANSI.sub("", s))

    def _repaint(self, target: str) -> None:
        """Morph the terminal line from ``self._on_screen`` to ``target``.

        ANSI-aware: callers color words (green committed / yellow
        assumption, examples/run_streaming.py), so the backspace count
        uses VISIBLE length — counting escape bytes as columns walked the
        cursor back into committed text and erased it. The diff point
        also snaps back out of any escape sequence it lands inside.
        """
        keep = 0
        limit = min(len(self._on_screen), len(target))
        while keep < limit and self._on_screen[keep] == target[keep]:
            keep += 1
        # Never split an escape sequence: back up to the ESC that opened
        # the sequence containing position `keep`, if any.
        esc = self._on_screen.rfind("\x1b", 0, keep)
        if esc != -1:
            m = self._ANSI.match(self._on_screen, esc)
            if m and m.end() > keep:
                keep = esc
        if len(self._on_screen) > keep:
            self._out.write(
                "\b" * self._visible_len(self._on_screen[keep:])
                + self._clear_eol)
        self._out.write(target[keep:])
        self._on_screen = target
        self._out.flush()

    def write(self, committed, assumption) -> None:
        self._all_committed.extend(w["text"] for w in committed)
        if not committed and not assumption:
            return
        self._repaint("".join(self._all_committed)
                      + "".join(w["text"] for w in assumption))

    def close(self) -> None:
        # Drop any assumption remnant; keep the committed transcript.
        self._repaint("".join(self._all_committed))
        self._out.write("\n" + self._show_cursor)
        self._out.flush()
        self._all_committed = []
        self._on_screen = ""
